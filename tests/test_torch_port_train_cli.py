"""The port's training data pipeline and training CLIs on the CPU against
the JAX package's: ``data/train_datasets`` (``PoseDataset``, ``get_data``)
against the JAX module on PNG folders written here; the port's
``scripts.train_posenet.main(..., --force_cpu)`` against
``scripts/train_posenet.main(args, config, force_cpu=True)`` at 64x96
from the same JAX checkpoint directory (``--restore_ckpt``), with RAFT
frozen for the whole run (``freeze_flow_steps`` absent: stop_flow_grad)
and unfrozen after 2 steps; the NaN-stop; the RAFT warm start from a
reference-format ``.pth``; ``configuration/train.yaml``'s
``freeze_flow_steps`` of 10^18; ``bench_train_step``'s ``build`` and one
remat step.

Tolerances: dataset pairs, relative poses, baselines, images and masks
bit for bit. CLI runs: the same number of steps and validations, the
validation losses within rtol 1e-3, and every weight of the best and the
last checkpoint within 2 lr x the steps of the run plus 1e-4 of its
leaf's largest value (Adam moves a parameter by at most ~lr a step, in a
direction that is rounding noise where the gradient is; see
tests/test_torch_port_train_unfreeze.py); RAFT's weights, frozen in both
runs, bit for bit. The JAX CLI runs on a one-device mesh.
"""
import argparse
import copy
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from robust_pose_tpu.data import train_datasets as jtd
from robust_pose_tpu_torch.data import train_datasets as ptd
from tests.test_torch_port_common import (  # noqa: F401 (fixture)
    TRAIN_H,
    TRAIN_W,
    jax_variables,
    train_config,
    train_weights,
    two_torch_threads,
)
from tests.test_torch_port_data import _write_calib, write_png_sequence

H, W = TRAIN_H, TRAIN_W
N_FRAMES = 8
LR = 1e-6
EPOCHS = 2                 # the loop stops once its step count exceeds this
VAL_TOL = 1e-3

pytestmark = pytest.mark.usefixtures("two_torch_threads")


def write_sequence(root, keyframes=0, masks=True, nan_pose=False, calib=None):
    """A sequence folder of N_FRAMES stereo PNGs (tests/test_torch_port_
    data.py's recipe): flat, or in ``keyframes`` ``keyframe_k`` folders;
    with or without ``masks/``; ``nan_pose`` writes NaN translations in
    every ground-truth line; ``calib`` replaces the calibration that
    get_data reads (the flat folder's or keyframe_1's) by a distorted one
    in that format (``_write_calib``: json, ini or yaml)."""
    dirs = [root] if not keyframes else [root / f"keyframe_{k}"
                                          for k in range(1, keyframes + 1)]
    for d in dirs:
        d.mkdir(parents=True)
        write_png_sequence(d, n=N_FRAMES)
        if calib is not None and d == dirs[0]:
            (d / "camcal.json").unlink()
            _write_calib(d, calib)
        if not masks:
            shutil.rmtree(d / "masks")
        if nan_pose:
            lines = (d / "groundtruth.txt").read_text().splitlines()
            (d / "groundtruth.txt").write_text("\n".join(
                " ".join([ln.split()[0], "nan"] + ln.split()[2:])
                for ln in lines) + "\n")
    return str(root)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """Training sequences ``a`` (flat, masks, a distorted json
    calibration) and ``b`` (two keyframes, no masks, yaml), validation
    ``v`` (flat), ``nan`` (NaN translations), and the keyframe layouts
    ``ka`` (masks) and ``kb`` (none, ini)."""
    root = tmp_path_factory.mktemp("train_cli")
    write_sequence(root / "a", calib="json")
    write_sequence(root / "b", keyframes=2, masks=False, calib="yaml")
    write_sequence(root / "v")
    write_sequence(root / "nan", nan_pose=True)
    write_sequence(root / "ka", keyframes=2)
    write_sequence(root / "kb", keyframes=1, masks=False, calib="ini")
    return str(root)


# --- datasets -------------------------------------------------------------------

def assert_same_dataset(got, want):
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        for g, w in zip(got[i], want[i]):
            assert np.asarray(g).dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seqs,step,samples", [
    (["a"], [1, 3], -1),          # flat, masks, step a pair
    (["b"], 2, -1),               # keyframes, no masks, step an int
    (["a", "v"], [1, 4], 3),      # two flat sequences, samples > 0
    (["ka", "kb"], [2, 3], 2),    # keyframe layout with and without masks
])
def test_get_data_matches_jax(base, seqs, step, samples):
    """Same pairs (one generator shared by the sequences), relative poses,
    scaled baselines, images and masks, bit for bit."""
    cfg = {"basepath": base, "sequences": seqs, "step": step,
           "samples": samples}
    got = ptd.get_data(cfg, (H, W), 250.0)
    want = jtd.get_data(cfg, (H, W), 250.0)
    for g, w in zip(got.datasets, want.datasets):
        assert g.image_list == w.image_list and g.mask_list == w.mask_list
        np.testing.assert_array_equal(np.stack(g.rel_pose_list),
                                      np.stack(w.rel_pose_list))
    assert_same_dataset(got, want)


def test_pose_dataset_matches_jax(base):
    """PoseDataset alone, with its own default generator, a cut-off and
    intrinsics given directly; and an empty folder refused by both."""
    k = np.array([[90.0, 0, 40], [0, 95.0, 30], [0, 0, 1]])
    root = os.path.join(base, "a")
    got = ptd.PoseDataset(root, 12.5, k, 300.0, 0.0, (1, 4), (H, W), 3)
    want = jtd.PoseDataset(root, 12.5, k, 300.0, 0.0, (1, 4), (H, W), 3)
    assert_same_dataset(got, want)
    assert float(got[0][8]) == np.float32(12.5 / 300.0)
    empty = os.path.join(base, "empty")
    os.makedirs(os.path.join(empty, "video_frames"), exist_ok=True)
    shutil.copy(os.path.join(root, "groundtruth.txt"), empty)
    with pytest.raises(FileNotFoundError, match="0 left"):
        ptd.PoseDataset(empty, 1.0, k)
    with pytest.raises(AssertionError):
        jtd.PoseDataset(empty, 1.0, k)


# --- the CLIs ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The JAX ``save_checkpoint`` directory both CLIs restore from: the
    training tests' weights (flow head biased to ~-1.6 px flows: valid
    depth at the rectified baseline)."""
    from robust_pose_tpu.utils.checkpoints import save_checkpoint

    sd = train_weights(seed=41)
    d = str(tmp_path_factory.mktemp("train_cli_ckpt") / "init")
    save_checkpoint(d, jax_variables(sd), {"model": train_config()["model"]})
    return d, sd


def cli_config(base, freeze=None, val="v", epochs=EPOCHS):
    cfg = train_config(learning_rate=LR, epochs=epochs)
    if freeze is not None:
        cfg["train"]["freeze_flow_steps"] = freeze
    cfg["data"] = {
        "train": {"basepath": base, "sequences": ["a", "b"], "step": [1, 3],
                  "samples": -1},
        "val": {"basepath": base, "sequences": [val], "step": 1, "samples": 4}}
    cfg["val"] = {"batch_size": 2}
    return cfg


def record_val(monkeypatch, module):
    """Record every validation loss ``run_val`` of ``module`` returns."""
    losses = []
    inner = module.run_val

    def recorded(*a, **kw):
        losses.append(inner(*a, **kw))
        return losses[-1]

    monkeypatch.setattr(module, "run_val", recorded)
    return losses


def run_jax(monkeypatch, cfg, ckpt, out):
    from robust_pose_tpu.parallel import mesh
    from scripts import train_posenet as jcli

    one = mesh.make_mesh
    monkeypatch.setattr(mesh, "make_mesh", lambda n=None: one(1))
    monkeypatch.setattr(jcli, "VAL_FREQ", 2)
    losses = record_val(monkeypatch, jcli)
    args = argparse.Namespace(name="posenet", outpath=out, log=False,
                              restore_ckpt=ckpt)
    with jax.default_matmul_precision("float32"):
        state = jcli.main(args, copy.deepcopy(cfg), force_cpu=True)
    return int(state.step), losses


def run_port(monkeypatch, cfg, ckpt, out, data=None):
    from robust_pose_tpu_torch.scripts import train_posenet as pcli

    monkeypatch.setattr(pcli, "VAL_FREQ", 2)
    losses = record_val(monkeypatch, pcli)
    argv = ["--name", "posenet", "--outpath", out, "--force_cpu"]
    args = pcli.build_parser().parse_args(
        argv + (["--restore_ckpt", ckpt] if ckpt else []))
    if data is None:
        state = pcli.main(args, copy.deepcopy(cfg))
    else:
        state = pcli.run(args, copy.deepcopy(cfg), *data)
    return state, losses


@pytest.fixture(scope="module", params=["frozen", "unfreeze2"])
def both_clis(request, base, checkpoint, tmp_path_factory):
    """Both CLIs on the same folders from the same checkpoint: RAFT frozen
    for the whole run, or unfrozen after 2 steps."""
    mp = pytest.MonkeyPatch()
    cfg = cli_config(base, None if request.param == "frozen" else 2)
    out = tmp_path_factory.mktemp("out_" + request.param)
    try:
        jstep, jloss = run_jax(mp, cfg, checkpoint[0], str(out / "jax"))
        pstate, ploss = run_port(mp, cfg, checkpoint[0], str(out / "port"))
    finally:
        mp.undo()
    return {"which": request.param, "out": out, "sd": checkpoint[1],
            "jax": (jstep, jloss), "port": (pstate, ploss)}


def test_clis_take_the_same_steps_and_validations(both_clis):
    jstep, jloss = both_clis["jax"]
    pstate, ploss = both_clis["port"]
    assert jstep == pstate.step == EPOCHS + 1
    assert len(jloss) == len(ploss) == 2
    np.testing.assert_allclose(ploss, jloss, rtol=VAL_TOL)
    assert np.isfinite(ploss).all()


@pytest.mark.parametrize("which", ["posenet", "posenet_last"])
def test_clis_write_the_same_checkpoints(both_clis, which):
    """The best and the last checkpoint, each read by the port's
    ``load_checkpoint_any``; the JAX one from its msgpack directory."""
    from robust_pose_tpu_torch.utils.checkpoints import load_checkpoint_any

    out, sd = both_clis["out"], both_clis["sd"]
    got = load_checkpoint_any(str(out / "port" / which))
    want = load_checkpoint_any(str(out / "jax" / which))
    frozen = both_clis["which"] == "frozen"
    assert got["config"]["train"] == want["config"]["train"]
    assert set(got["state_dict"]) == set(want["state_dict"])
    for k, w in want["state_dict"].items():
        g = got["state_dict"][k]
        if frozen and k.startswith("flow."):
            assert torch.equal(g, w) and torch.equal(g, sd[k]), k
            continue
        tol = 2 * LR * (EPOCHS + 1) + 1e-4 * float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=tol,
                                   err_msg=k)
    # the heads move from the first step; RAFT from the third (the
    # unfreeze), which the last checkpoint follows (the best one may be
    # either validation's: the two losses lie within the packages' spread)
    k = "weight_head_2d.unet.head.weight"
    assert not torch.equal(got["state_dict"][k], sd[k])
    if not frozen and which == "posenet_last":
        k = "flow.fnet.conv1.weight"
        assert not torch.equal(got["state_dict"][k], sd[k])


def nan_validation(monkeypatch, module):
    """Make ``module.get_data`` give the validation sequence ``v`` NaN
    relative poses (what a NaN pose in its ground truth would be)."""
    inner = module.get_data

    def patched(cfg, *a):
        ds = inner(cfg, *a)
        if cfg["sequences"] == ["v"]:
            for d in ds.datasets:
                d.rel_pose_list = [np.full(7, np.nan) for _ in d.rel_pose_list]
        return ds

    monkeypatch.setattr(module, "get_data", patched)


def test_nan_validation_stops_both_clis_at_step_0(base, checkpoint, tmp_path):
    """Validation pairs with NaN poses: both CLIs take one step, stop at its
    validation (a NaN loss) and write no checkpoint."""
    cfg = cli_config(base)
    with pytest.MonkeyPatch.context() as mp:
        nan_validation(mp, jtd)
        nan_validation(mp, ptd)
        jstep, jloss = run_jax(mp, cfg, checkpoint[0], str(tmp_path / "jax"))
        pstate, ploss = run_port(mp, cfg, checkpoint[0], str(tmp_path / "port"))
    assert jstep == 1 and pstate.step == 1
    assert len(jloss) == len(ploss) == 1
    assert np.isnan(jloss).all() and np.isnan(ploss).all()
    assert os.listdir(tmp_path / "jax") == os.listdir(tmp_path / "port") == []


def test_nan_ground_truth_is_refused_by_both_datasets(base):
    """A NaN translation in a ground-truth file never reaches the loss: the
    relative pose of a pair whose first frame has it has no rotation, and
    both packages' datasets fail on it alike."""
    cfg = {"basepath": base, "sequences": ["nan"], "step": 1, "samples": -1}
    with pytest.raises(np.linalg.LinAlgError):
        jtd.get_data(cfg, (H, W), 250.0)
    with pytest.raises(np.linalg.LinAlgError):
        ptd.get_data(cfg, (H, W), 250.0)


def test_raft_warm_start_from_a_reference_pth(base, tmp_path):
    """``model.pretrained`` names a reference RAFT ``.pth`` (DataParallel
    prefixes): after a frozen run the port's RAFT holds exactly the
    weights and buffers of the JAX converter + ``params_from_jax``."""
    from robust_pose_tpu.utils.torch_convert import convert_raft_pth
    from robust_pose_tpu_torch.utils.convert import params_from_jax
    from tests.torch_ref.raft import RAFT as RefRAFT

    torch.manual_seed(5)
    ref = RefRAFT()
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.2)
                m.running_var.uniform_(0.8, 1.5)
    path = str(tmp_path / "raft-things.pth")
    torch.save({f"module.{k}": v for k, v in ref.state_dict().items()}, path)
    cfg = cli_config(base, epochs=0)
    cfg["model"]["pretrained"] = path
    with pytest.MonkeyPatch.context() as mp:
        state, _ = run_port(mp, cfg, None, str(tmp_path / "port"))
    want = params_from_jax(convert_raft_pth(path))
    got = {**state.params, **state.batch_stats}
    assert {k for k in got if k.startswith("flow.")} == {"flow." + k for k in want}
    for k, v in want.items():
        assert torch.equal(got["flow." + k].detach(), v), k
    assert state.step == 1


def test_train_yaml_freeze_count(base, checkpoint, tmp_path):
    """``configuration/train.yaml``'s ``freeze_flow_steps`` (10^18, finite,
    so RAFT's gradients are live): the JAX trainer's int32 count overflows
    at the first step; the port's CLI runs it with RAFT bit-equal."""
    from robust_pose_tpu_torch.utils.config import read_yaml
    from tests.test_torch_port_common import jax_trainer, train_batch

    freeze = read_yaml("configuration/train.yaml")["train"]["freeze_flow_steps"]
    assert freeze == 10 ** 18
    cfg = cli_config(base, freeze, epochs=1)
    tr, st, _ = jax_trainer(cfg, checkpoint[1])
    with pytest.raises(OverflowError):
        tr.make_train_step()(st, train_batch(seed=3))
    with pytest.MonkeyPatch.context() as mp:
        state, losses = run_port(mp, cfg, checkpoint[0], str(tmp_path))
    assert state.step == 2 and np.isfinite(losses).all()
    sd = checkpoint[1]
    for k, v in state.params.items():
        if k.startswith("flow."):
            assert torch.equal(v.detach(), sd[k]), k
    k = "weight_head_2d.unet.head.weight"
    assert not torch.equal(state.params[k].detach(), sd[k])


def test_bench_train_step_builds_and_steps(monkeypatch):
    """``build`` and one remat step on the CPU at 64x96 (the heads cut to
    one UNet level: three need 384x512), on a batch made from a generator
    on the device."""
    from robust_pose_tpu_torch.models.posenet import PoseNet
    from robust_pose_tpu_torch.scripts import bench_train_step as bts
    from robust_pose_tpu_torch.train import trainer as T

    monkeypatch.setattr(bts, "H", H)
    monkeypatch.setattr(bts, "W", W)
    monkeypatch.setattr(T, "PoseNet", lambda cfg, device=None: PoseNet(
        {**cfg, "unet_levels": 1}, device=device))
    tr, st = bts.build(2, remat=True, device="cpu")
    assert tr.model.flow.remat and tr.model.config["stop_flow_grad"]
    batch = bts.make_batch(2, device="cpu")
    assert batch[0].shape == (2, 3, H, W) and batch[4].dtype == torch.bool
    assert torch.equal(bts.make_batch(2, device="cpu")[0], batch[0])
    flow0 = {k: v.detach().clone() for k, v in st.params.items()}
    st, m = tr.train_step(st, batch)
    assert st.step == 1 and all(np.isfinite(float(v)) for v in m.values())
    assert torch.equal(st.params["flow.fnet.conv1.weight"],
                       flow0["flow.fnet.conv1.weight"])
