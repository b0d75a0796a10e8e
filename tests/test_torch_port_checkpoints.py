"""The port's checkpoints (``utils.checkpoints``, ``utils.torch_convert``) on
the CPU: its own bundle, a directory the JAX package's ``save_checkpoint``
wrote, a reference-format ``.pth`` (through the JAX converter and
``params_from_jax`` on one side, the port's loader on the other), the small
variant refused, and training states that resume bit for bit."""
import flax.serialization
import jax
import numpy as np
import pytest
import torch

from robust_pose_tpu.utils.checkpoints import save_checkpoint as j_save_checkpoint
from robust_pose_tpu.utils.torch_convert import (
    convert_posenet_state_dict as j_convert_posenet,
)
from robust_pose_tpu_torch.models.posenet import PoseNet
from robust_pose_tpu_torch.slam.pose_estimator import PoseEstimator
from robust_pose_tpu_torch.utils.checkpoints import (
    load_checkpoint,
    load_checkpoint_any,
    load_train_state,
    msgpack_restore,
    save_checkpoint,
    save_train_state,
)
from robust_pose_tpu_torch.utils.convert import params_from_jax, train_state_from_jax
from tests.test_torch_port_common import (  # noqa: F401 (fixture)
    jax_trainer,
    jax_variables,
    random_state_dict,
    train_batch,
    train_config,
    train_weights,
    two_torch_threads,
)
from tests.torch_ref.posenet import PoseNet as RefPoseNet

H, W = 64, 96
MODEL_CFG = {"image_shape": [H, W], "iters": 1, "lbgfs_iters": 5,
             "use_weights": True, "mixed_precision": False, "unet_levels": 1}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().view(torch.int32)


def assert_same_state_dict(a, b):
    """Same keys, shapes, dtypes and bits."""
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(_bits(a[k].float()), _bits(b[k].float())), k


@pytest.mark.parametrize("small", [False, True])
def test_port_bundle_round_trip(tmp_path, small):
    """``save_checkpoint`` then ``load_checkpoint`` and
    ``load_checkpoint_any``: the same state_dict bit for bit and the same
    config; a PoseEstimator built from it runs a first frame."""
    cfg = dict(MODEL_CFG, small=small)
    sd = random_state_dict(PoseNet(cfg, device="cpu"), seed=1)
    save_checkpoint(str(tmp_path), sd, {"model": cfg})
    for got in (load_checkpoint(str(tmp_path)), load_checkpoint_any(str(tmp_path))):
        assert got["config"] == {"model": cfg}
        assert_same_state_dict(got["state_dict"], sd)
    slam = {"frame2frame": True, "lbgfs_iters": 5, "conf_weighing": True,
            "depth_clipping": [1, 250]}
    K = np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1.0]])
    est = PoseEstimator(slam, K, 250.0, load_checkpoint_any(str(tmp_path)),
                        (W, H), device="cpu")
    img = np.random.default_rng(0).uniform(0, 255, (1, 3, H, W)).astype(np.float32)
    est(img, img, np.ones((1, 1, H, W), bool))
    assert est.frame is not None


def test_jax_checkpoint_directory(tmp_path):
    """A directory written by the JAX package's ``save_checkpoint`` (flax
    msgpack): the port's reader gives the tree flax's own restore gives,
    leaf for leaf, and ``load_checkpoint`` equals ``params_from_jax`` of the
    same variables bit for bit, which PoseNet loads strictly."""
    cfg = dict(MODEL_CFG, small=True)
    sd = random_state_dict(PoseNet(cfg, device="cpu"), seed=2)
    variables = jax_variables(sd)
    j_save_checkpoint(str(tmp_path), variables, {"model": cfg})
    data = (tmp_path / "checkpoint.msgpack").read_bytes()
    ref_tree = flax.serialization.msgpack_restore(data)
    ours = msgpack_restore(data)
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref_tree)
    our_leaves = dict(jax.tree_util.tree_leaves_with_path(ours))
    assert len(ref_leaves) == len(our_leaves) > 0
    for path, leaf in ref_leaves:
        assert our_leaves[path].dtype == leaf.dtype
        np.testing.assert_array_equal(our_leaves[path], leaf)
    got = load_checkpoint(str(tmp_path))
    assert got["config"] == {"model": cfg}
    assert_same_state_dict(got["state_dict"], params_from_jax(variables))
    assert_same_state_dict(got["state_dict"], sd)
    PoseNet(cfg, device="cpu").load_state_dict(got["state_dict"])


def _reference_posenet(seed):
    torch.manual_seed(seed)
    ref = RefPoseNet({"image_shape": (H, W), "iters": 1})
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.2)
                m.running_var.uniform_(0.8, 1.5)
    return ref


def test_reference_pth_matches_the_jax_converter(tmp_path):
    """A randomly initialised reference PoseNet (``tests/torch_ref``), saved
    as a DataParallel ``.pth`` (``module.`` prefixes): the JAX converter and
    ``params_from_jax`` on one side, the port's ``load_checkpoint_any`` on
    the other give the same state_dict bit for bit (``convc1``'s window
    channels permuted alike), which the large PoseNet loads strictly."""
    sd = _reference_posenet(3).state_dict()
    path = tmp_path / "posenet.pth"
    cfg = {"model": {"image_shape": [H, W], "iters": 1}}
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()},
                "config": cfg}, path)
    got = load_checkpoint_any(str(path))
    assert got["config"] == cfg
    ref = params_from_jax(j_convert_posenet({k: v.numpy() for k, v in sd.items()}))
    assert_same_state_dict(got["state_dict"], ref)
    key = "flow.update.update_block.encoder.convc1.weight"
    assert not torch.equal(got["state_dict"][key], sd["flow." + key[len("flow.update."):]])
    PoseNet({"image_shape": (H, W), "iters": 1}, device="cpu").load_state_dict(
        got["state_dict"])


@pytest.mark.parametrize("how", ["config", "weights"])
def test_small_reference_pth_is_refused(tmp_path, how):
    """A reference checkpoint of the small variant, named by its config or
    seen in its weights (a 32-channel fnet stem), raises a clear error
    instead of failing on a shape deep in ``load_state_dict``."""
    sd = _reference_posenet(4).state_dict()
    cfg = {"model": {"image_shape": [H, W], "small": how == "config"}}
    if how == "weights":
        sd["flow.fnet.conv1.weight"] = sd["flow.fnet.conv1.weight"][:32]
    path = tmp_path / "small.pth"
    torch.save({"state_dict": sd, "config": cfg}, path)
    with pytest.raises(ValueError, match="small variant"):
        load_checkpoint_any(str(path))


def _resume_config():
    """RAFT small and live (lookup "xla"), dropout 0.1 and remat "dots", so
    that the resumed step must draw the same dropout masks from the step."""
    cfg = train_config(freeze_flow_steps=0)
    cfg["model"].update(small=True, dropout=0.1, remat=True,
                        remat_policy="dots", iters=1, lbgfs_iters=10)
    return cfg


@pytest.mark.usefixtures("two_torch_threads")
def test_resumed_step_equals_the_uninterrupted_one(tmp_path):
    """Step 1, ``save_train_state``, step 2; a fresh trainer from
    ``load_train_state`` takes step 2 again: its loss, parameters,
    BatchNorm statistics, Adam moments, count and step equal the
    uninterrupted run's bit for bit on the CPU."""
    from robust_pose_tpu_torch.train.trainer import PoseNetTrainer

    cfg = _resume_config()
    sd = random_state_dict(PoseNet(dict(cfg["model"], image_shape=(H, W)),
                                   device="cpu"), seed=6)
    b1, b2 = train_batch(seed=1), train_batch(seed=2)
    tr = PoseNetTrainer(cfg, device="cpu")
    st = tr.init_state(sd)
    st, _ = tr.train_step(st, b1)
    save_train_state(str(tmp_path), st)
    st, m_a = tr.train_step(st, b2)

    tr2 = PoseNetTrainer(cfg, device="cpu")
    st2 = tr2.init_state(load_train_state(str(tmp_path)))
    assert st2.step == 1 and st2.opt_state.count == 1
    st2, m_b = tr2.train_step(st2, b2)
    assert torch.equal(m_a["train/loss_total"], m_b["train/loss_total"])
    assert st2.step == st.step == 2 and st2.opt_state.count == 2
    for a, b in ((st.params, st2.params), (st.batch_stats, st2.batch_stats),
                 (st.opt_state.mu, st2.opt_state.mu),
                 (st.opt_state.nu, st2.opt_state.nu)):
        assert_same_state_dict(a, b)


def test_jax_train_state_round_trips(tmp_path):
    """A JAX TrainState through ``utils.convert.train_state_from_jax``, into
    the port's trainer, ``save_train_state`` and ``load_train_state``: the
    weights, statistics, moments, count and step come back bit for bit."""
    from robust_pose_tpu_torch.train.trainer import PoseNetTrainer

    cfg = train_config()
    sd = train_weights()
    _, jstate, _ = jax_trainer(cfg, sd)
    conv = train_state_from_jax(jstate)
    tr = PoseNetTrainer(cfg, device="cpu")
    st = tr.init_state(conv)
    save_train_state(str(tmp_path), st)
    back = load_train_state(str(tmp_path))
    assert back["count"] == conv["count"] and back["step"] == conv["step"]
    for k in ("state_dict", "mu", "nu"):
        assert_same_state_dict(back[k], conv[k])
