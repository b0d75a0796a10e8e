"""The port's golden-parity harness (``robust_pose_tpu_torch/scripts/
verify_parity.py``) against the JAX package's (``scripts/verify_parity.py``,
imported by path) on the CPU at 384x512 (the smallest shape the 3-level
TinyUNet takes), 2 frames, 2 GRU iterations.

The JAX harness writes the selftest ``.pth`` (``make_selftest_pth``) and a
golden from its reference network (``load_torch_oracle`` /
``run_torch_oracle``, saved with its ``np.savez_compressed`` call); then:
(a) the port's ``make_selftest_pth`` writes the same state_dict and config
bit for bit; (b) the port's own copy of the reference network
(``robust_pose_tpu_torch/reference``) gives ``tests/torch_ref``'s outputs
bit for bit; (c) the port's per-frame outputs (``--device cpu``) against
the JAX harness's ``run_jax`` on the same ``.pth``: flow atol 1e-3 px,
confidences atol 1e-4, depth rtol 1e-4, pose tangent distance 1e-4 (the
slice tolerances of ``tests/test_torch_port_slice.py``); (d) ``--golden``
exits 0 with the JAX ``compare``'s row names and verdicts, the values
within (c)'s tolerances; (e) a golden pose moved by 1e-2 in tangent space
fails that row and exits 1; (f) ``--raft`` reports the JAX converter's
parameter count; (g) ``--data`` reads PNG pairs as the JAX harness does.
"""
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from robust_pose_tpu import se3 as jse3
from robust_pose_tpu.utils.torch_convert import convert_posenet_pth as j_convert
from robust_pose_tpu.utils.torch_convert import convert_raft_pth as j_convert_raft
from robust_pose_tpu_torch import se3
from robust_pose_tpu_torch.scripts import verify_parity as pvp
from robust_pose_tpu_torch.utils.torch_convert import convert_posenet_pth

ROOT = Path(__file__).resolve().parents[1]
H, W = 384, 512
FRAMES, ITERS = 2, 2
CFG = {"image_shape": (H, W), "iters": ITERS, "lbgfs_iters": 25,
       "use_weights": True}
K = np.array([[350.0, 0, W / 2], [0, 350.0, H / 2], [0, 0, 1.0]], np.float32)
BASELINE = 20.0
HARNESS = ["--frames", str(FRAMES), "--iters", str(ITERS), "--device", "cpu"]
OUT_KEYS = ("pose", "flow", "depth2", "conf1", "conf2")   # a frame's outputs


def _jax_harness():
    spec = importlib.util.spec_from_file_location(
        "jax_verify_parity", ROOT / "scripts" / "verify_parity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jvp = _jax_harness()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX harness's selftest .pth, frames, reference-network outputs
    and golden, and its ``run_jax`` outputs; the port's .pth beside."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("parity")
    pth, port_pth = str(root / "j.pth"), str(root / "p.pth")
    jvp.make_selftest_pth(pth, CFG)
    pvp.make_selftest_pth(port_pth, CFG)
    frames = jvp.make_synthetic_sequence(H, W, n=FRAMES)
    ref = jvp.run_torch_oracle(jvp.load_torch_oracle(pth, CFG), frames, K,
                               BASELINE, CFG)
    golden = str(root / "golden.npz")
    recordable = [{k: v for k, v in r.items() if k != "_obj"} for r in ref]
    np.savez_compressed(golden, outs=np.asarray(recordable, dtype=object))
    jax_outs = jvp.run_jax(j_convert(pth)["params"], frames, K, BASELINE, CFG)
    yield {"root": root, "pth": pth, "port_pth": port_pth, "frames": frames,
           "ref": ref, "golden": golden, "jax": jax_outs}
    torch.set_num_threads(n)


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


def _tangent(a, b):
    """max |log(a^-1 b)| of two 7-vectors, in f64."""
    a, b = (torch.tensor(np.array(x), dtype=torch.float64)[None] for x in (a, b))
    return float(se3.log(se3.mul(se3.inv(a), b)).abs().max())


def test_selftest_pth_is_the_jax_harness_bit_for_bit(setup):
    """(a) the same keys, dtypes, shapes and bits, and the same config."""
    j = torch.load(setup["pth"], weights_only=False)
    p = torch.load(setup["port_pth"], weights_only=False)
    assert p["config"] == j["config"]
    assert set(p["state_dict"]) == set(j["state_dict"])
    for k, v in j["state_dict"].items():
        w = p["state_dict"][k]
        assert w.dtype == v.dtype and w.shape == v.shape, k
        assert torch.equal(_bits(w.float()), _bits(v.float())), k


def test_reference_copy_gives_the_oracles_outputs_bit_for_bit(setup):
    """(b) ``robust_pose_tpu_torch/reference`` through the port's
    ``load_torch_oracle`` / ``run_torch_oracle`` on the same .pth and
    frames: every output array and both objective values equal."""
    got = pvp.run_torch_oracle(pvp.load_torch_oracle(setup["pth"], CFG),
                               setup["frames"], K, BASELINE, CFG)
    assert len(got) == len(setup["ref"]) == FRAMES - 1
    for g, r in zip(got, setup["ref"]):
        for key in OUT_KEYS:
            assert g[key].dtype == r[key].dtype, key
            np.testing.assert_array_equal(g[key], r[key], err_msg=key)
        assert g["e_torch"] == r["e_torch"] and g["e_ident"] == r["e_ident"]
        assert g["_obj"](r["pose"]) == r["_obj"](r["pose"])


def test_synthetic_frames_match_the_jax_harness(setup):
    """The port's frames: OpenCV's where it is installed (bit for bit), and
    its own blur within 1e-4 grey levels of OpenCV's."""
    got = pvp.make_synthetic_sequence(H, W, n=FRAMES)
    for (gl, gr), (jl, jr) in zip(got, setup["frames"]):
        np.testing.assert_array_equal(gl, jl)
        np.testing.assert_array_equal(gr, jr)
    import cv2
    tex = np.random.default_rng(3).integers(0, 255, (40, 70, 3)).astype(np.float32)
    np.testing.assert_allclose(pvp.gaussian_blur(tex, 3.0),
                               cv2.GaussianBlur(tex, (0, 0), 3), atol=1e-4)


def test_port_outputs_match_run_jax(setup):
    """(c) the port on ``--device cpu`` against the JAX harness's run_jax."""
    sd = convert_posenet_pth(setup["pth"])["state_dict"]
    port = pvp.run_port(sd, setup["frames"], K, BASELINE, CFG,
                        torch.device("cpu"))
    for p, j in zip(port, setup["jax"]):
        for key in OUT_KEYS:
            assert p[key].shape == j[key].shape, key
        np.testing.assert_allclose(p["flow"], j["flow"], atol=1e-3)
        np.testing.assert_allclose(p["conf1"], j["conf1"], atol=1e-4)
        np.testing.assert_allclose(p["conf2"], j["conf2"], atol=1e-4)
        np.testing.assert_allclose(p["depth2"], j["depth2"], rtol=1e-4)
        assert _tangent(p["pose"], j["pose"]) <= 1e-4


def _jax_rows(setup, golden=None):
    ref = list(np.load(golden or setup["golden"], allow_pickle=True)["outs"])
    return jvp.compare(setup["jax"], ref, jse3)


def _port_rows(setup, tmp_path, *extra):
    out = tmp_path / "rows.json"
    rc = pvp.main(["--posenet", setup["pth"], *HARNESS, "--json", str(out),
                   *extra])
    with open(out) as f:
        return rc, json.load(f)["rows"]


# the bound of each row's value against the JAX harness's: (c)'s tolerance
# of the quantity the row measures (depth rows: relative already)
ROW_TOL = {"flow": 1e-3, "depth": 1e-4, "confidence": 1e-4, "pose": 1e-4,
           "chained": 1e-4}


def test_golden_rows_match_the_jax_compare(setup, tmp_path, capsys):
    """(d) and (f): ``--golden`` (with ``--raft`` on the reference
    network's RAFT) exits 0; its rows carry the JAX ``compare``'s names and
    verdicts, each value within its quantity's tolerance of the JAX one;
    and the RAFT line reports the JAX converter's parameter count."""
    raft = setup["root"] / "raft.pth"
    ref_net = pvp.load_torch_oracle(setup["pth"], CFG)
    torch.save(ref_net.flow.state_dict(), raft)
    rc, rows = _port_rows(setup, tmp_path, "--golden", setup["golden"],
                          "--raft", str(raft))
    assert rc == 0
    want = _jax_rows(setup)
    assert [r[0] for r in rows] == [w[0] for w in want]
    for (name, val, tol, ok), (_, jval, jtol, jok) in zip(rows, want):
        assert ok == bool(jok) and tol == jtol, name
        bound = ROW_TOL[name.split()[0]]
        assert abs(val - float(jval)) <= bound, (name, val, jval)
    printed = capsys.readouterr().out
    n_jax = len(jax.tree_util.tree_leaves(j_convert_raft(str(raft))["params"]))
    assert f"raft checkpoint converted: {n_jax} param tensors OK" in printed
    assert "PARITY: PASS" in printed


def test_a_moved_golden_pose_fails_its_row(setup, tmp_path):
    """(e) one golden pose moved by 1e-2 along a rotation axis: the pose
    row fails, as the JAX harness's does, and the harness exits 1."""
    outs = list(np.load(setup["golden"], allow_pickle=True)["outs"])
    moved = dict(outs[0])
    bump = se3.exp(torch.tensor([[0.0, 0.0, 0.0, 1e-2, 0.0, 0.0]],
                                dtype=torch.float64))
    moved["pose"] = se3.mul(bump, torch.as_tensor(moved["pose"], dtype=torch.float64
                                                  )[None])[0].float().numpy()
    outs[0] = moved
    bad = str(tmp_path / "moved.npz")
    np.savez_compressed(bad, outs=np.asarray(outs, dtype=object))
    rc, rows = _port_rows(setup, tmp_path, "--golden", bad)
    assert rc == 1
    verdict = {r[0].split()[0]: r[3] for r in rows}
    assert verdict["pose"] is False
    assert verdict["flow"] and verdict["depth"] and verdict["confidence"]
    jverdict = {r[0].split()[0]: bool(r[3]) for r in _jax_rows(setup, bad)}
    assert jverdict == verdict


def test_data_dir_is_read_as_the_jax_harness_reads_it(setup, tmp_path):
    """(g) ``--data``: PNG pairs (l_*/r_* and *_left/*_right names) read
    bit for bit as the JAX harness reads them, and the harness passes on
    them against the live reference network."""
    import cv2

    for i, (l, r) in enumerate(setup["frames"]):
        for name, img in ((f"l_{i:03d}.png", l), (f"r_{i:03d}.png", r)):
            cv2.imwrite(str(tmp_path / name),
                        cv2.cvtColor(np.clip(img, 0, 255).astype(np.uint8),
                                     cv2.COLOR_RGB2BGR))
    got = pvp.load_data_dir(str(tmp_path), H, W)
    want = jvp.load_data_dir(str(tmp_path), H, W)
    assert len(got) == len(want) == FRAMES
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
    rc, rows = _port_rows(setup, tmp_path, "--data", str(tmp_path))
    assert rc == 0 and all(r[3] for r in rows)
    assert rows[3][0] == "GN obj excess over LBFGS (rel)"


def test_golden_needs_the_checkpoint():
    """Like the JAX harness, which runs the network on the checkpoint's
    weights even with ``--golden``, the port's needs ``--posenet``."""
    with pytest.raises(SystemExit, match="--posenet"):
        pvp.main(["--golden", "x.npz", "--device", "cpu"])
