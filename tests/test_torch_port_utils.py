"""The port's host utilities on the CPU against the JAX package: the se3
functions of the trajectory slice (matrices, adjoint, random), trajectory
IO, ATE/RPE metrics and evaluation, the stage timer, the inference logger
and the configuration reader.

se3 within f32 tolerance (``random``: its distribution only); trajectory
files equal byte for byte; metrics within 1e-12 (numpy f64).
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.spatial.transform import Rotation

from robust_pose_tpu import se3 as jse3
from robust_pose_tpu.utils import evaluate as jev
from robust_pose_tpu.utils import logging as jlog
from robust_pose_tpu.utils import metrics as jmet
from robust_pose_tpu.utils import trajectory as jtraj
from robust_pose_tpu_torch import se3 as pse3
from robust_pose_tpu_torch.utils import evaluate as pev
from robust_pose_tpu_torch.utils import logging as plog
from robust_pose_tpu_torch.utils import metrics as pmet
from robust_pose_tpu_torch.utils import trajectory as ptraj
from robust_pose_tpu_torch.utils.config import read_yaml
from robust_pose_tpu_torch.utils.profiling import StageTimer

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = 1e-5


def _random_traj(n=50, seed=0):
    """tests/test_trajectory_metrics.py's random trajectory."""
    rng = np.random.default_rng(seed)
    mats = np.tile(np.eye(4), (n, 1, 1))
    mats[:, :3, 3] = np.cumsum(rng.normal(0, 5.0, (n, 3)), axis=0)
    mats[:, :3, :3] = Rotation.random(n, rng=rng).as_matrix()
    return mats


def _poses(n=64, seed=3, sigma=1.0):
    rng = np.random.default_rng(seed)
    tau = (sigma * rng.normal(size=(n, 6))).astype(np.float32)
    return np.asarray(jse3.exp(jnp.asarray(tau)))


# --- se3 ---------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["quat_to_matrix", "matrix", "adjoint"])
def test_se3_matrix_functions_match_jax(fn):
    g = _poses()
    arg = g[:, 3:] if fn == "quat_to_matrix" else g
    got = getattr(pse3, fn)(torch.from_numpy(arg)).numpy()
    ref = np.asarray(getattr(jse3, fn)(jnp.asarray(arg)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=F32_TOL)


@pytest.mark.parametrize("case", ["random", "w_dominant", "x_dominant",
                                  "y_dominant", "z_dominant"])
def test_quat_from_matrix_matches_jax(case):
    """Each of the four constructions is taken somewhere (rotations by
    about pi about x, y or z make that component dominant)."""
    if case == "random":
        R = np.asarray(jse3.quat_to_matrix(jnp.asarray(_poses()[:, 3:])))
    else:
        axis = {"w": None, "x": 0, "y": 1, "z": 2}[case[0]]
        rv = np.random.default_rng(4).normal(0, 0.05, (16, 3))
        if axis is not None:
            rv[:, axis] += np.pi - 0.1
        R = Rotation.from_rotvec(rv).as_matrix().astype(np.float32)
    got = pse3.quat_from_matrix(torch.from_numpy(R)).numpy()
    ref = np.asarray(jse3.quat_from_matrix(jnp.asarray(R)))
    np.testing.assert_allclose(got, ref, atol=F32_TOL)
    back = pse3.quat_to_matrix(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(back, R, atol=1e-5)


def test_se3_skew_and_from_matrix_match_jax():
    g = _poses()
    w = g[:, :3]
    np.testing.assert_array_equal(pse3.skew(torch.from_numpy(w)).numpy(),
                                  np.asarray(jse3.skew(jnp.asarray(w))))
    m = np.asarray(jse3.matrix(jnp.asarray(g)))
    got = pse3.from_matrix(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, np.asarray(jse3.from_matrix(jnp.asarray(m))),
                               atol=F32_TOL)
    # the round trip through the port alone, on a batch of shape (4, 16)
    g2 = torch.from_numpy(g.reshape(4, 16, 7))
    back = pse3.from_matrix(pse3.matrix(g2))
    assert back.shape == (4, 16, 7)
    d = pse3.log(pse3.mul(pse3.inv(g2), back))
    assert float(d.abs().max()) < 1e-5


def test_se3_adjoint_maps_tangents_as_jax_does():
    """Ad(g) eps = log(g exp(eps) g^-1) to first order, in the port."""
    g = torch.from_numpy(_poses(8, sigma=0.5))
    eps = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1e-5, (8, 6))).double()
    g = pse3.normalize(g.double())     # a unit quaternion in f64
    lhs = (pse3.adjoint(g) @ eps[..., None])[..., 0]
    rhs = pse3.log(pse3.mul(pse3.mul(g, pse3.exp(eps)), pse3.inv(g)))
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=1e-9)


def test_se3_random_distribution_matches_jax():
    """exp(N(0, sigma^2)): the tangents' mean and spread from the port's
    generator and from JAX's key agree (the bits do not)."""
    n, sigma = 20000, 0.3
    got = pse3.log(pse3.random(torch.Generator().manual_seed(0), (n,),
                               sigma=sigma).double()).numpy()
    ref = np.asarray(jse3.log(jse3.random(jax.random.PRNGKey(0), (n,),
                                          sigma=sigma)), np.float64)
    for tau in (got, ref):
        assert np.abs(tau.mean(0)).max() < 5 * sigma / np.sqrt(n)
    np.testing.assert_allclose(got.std(0), ref.std(0), rtol=0.05)
    np.testing.assert_allclose(got.std(0), sigma, rtol=0.05)
    g = pse3.random(torch.Generator().manual_seed(1), (2, 3))
    assert g.shape == (2, 3, 7) and g.dtype == torch.float32
    np.testing.assert_allclose(torch.linalg.norm(g[..., 3:], dim=-1).numpy(),
                               1.0, atol=1e-6)


# --- trajectory IO -------------------------------------------------------------------

def test_mat2vec_vec2mat_match_jax():
    mats = _random_traj()
    vecs = ptraj.mat2vec(mats)
    np.testing.assert_array_equal(vecs, jtraj.mat2vec(mats))
    np.testing.assert_array_equal(ptraj.vec2mat(vecs), jtraj.vec2mat(vecs))
    np.testing.assert_allclose(ptraj.vec2mat(vecs), mats, atol=1e-10)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_freiburg_files_match_jax_byte_for_byte(tmp_path, dtype):
    vecs = ptraj.mat2vec(_random_traj(20)).astype(dtype)
    traj = [{"camera-pose": v, "timestamp": 100 * i} for i, v in enumerate(vecs)]
    ptraj.save_trajectory(traj, str(tmp_path / "port"))
    jtraj.save_trajectory(traj, str(tmp_path / "jax"))
    a = (tmp_path / "port" / "trajectory.freiburg").read_bytes()
    assert a == (tmp_path / "jax" / "trajectory.freiburg").read_bytes()
    for kw in ({}, {"ret_stamps": True}):
        got = ptraj.read_freiburg(str(tmp_path / "port" / "trajectory.freiburg"), **kw)
        ref = jtraj.read_freiburg(str(tmp_path / "jax" / "trajectory.freiburg"), **kw)
        for g, r in zip(got if kw else [got], ref if kw else [ref]):
            np.testing.assert_array_equal(g, r)


def test_read_freiburg_variants_match_jax(tmp_path):
    """Decimal timestamps (the collapse heuristic), commas and tabs,
    comments, and files without timestamps."""
    p = tmp_path / "t.txt"
    p.write_text("# tx ty tz qx qy qz qw\n"
                 "1403636579.763555\t0.1,0.2,0.3 0 0 0 1\n"
                 "1403636579.813555 0.11 0.21 0.31 0 0 0.0998 0.995\n")
    for kw in ({"ret_stamps": True}, {}):
        got, ref = ptraj.read_freiburg(str(p), **kw), jtraj.read_freiburg(str(p), **kw)
        for g, r in zip(got if kw else [got], ref if kw else [ref]):
            np.testing.assert_array_equal(g, r)
    q = tmp_path / "n.txt"
    q.write_text("0.1 0.2 0.3 0 0 0 1\n0.2 0.2 0.3 0 0 0 1\n")
    np.testing.assert_array_equal(ptraj.read_freiburg(str(q), no_stamp=True),
                                  jtraj.read_freiburg(str(q), no_stamp=True))


def test_json_trajectories_match_jax(tmp_path):
    import json

    mats = _random_traj(6)
    (tmp_path / "a.json").write_text(json.dumps(
        [{"camera-pose": m.tolist(), "timestamp": i} for i, m in enumerate(mats)]))
    ptraj.json2freiburg(str(tmp_path / "a.json"), str(tmp_path / "port"))
    jtraj.json2freiburg(str(tmp_path / "a.json"), str(tmp_path / "jax"))
    assert ((tmp_path / "port" / "trajectory.freiburg").read_bytes()
            == (tmp_path / "jax" / "trajectory.freiburg").read_bytes())
    (tmp_path / "b.json").write_text(json.dumps(
        [{"camera_pose": list(m[:3, 3]) + list(m[:3, :3].reshape(-1)),
          "timestamp": 10 * i} for i, m in enumerate(mats)]))
    got = ptraj.read_json_intuitive(str(tmp_path / "b.json"))
    ref = jtraj.read_json_intuitive(str(tmp_path / "b.json"))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(
        ptraj.read_json_intuitive(str(tmp_path / "a.json"), with_stamp=False),
        jtraj.read_json_intuitive(str(tmp_path / "a.json"), with_stamp=False))


# --- metrics and evaluation ----------------------------------------------------------

def _noisy(mats, seed=1, scale=2.0):
    out = mats.copy()
    out[:, :3, 3] += np.random.default_rng(seed).normal(0, scale, (len(mats), 3))
    return out


@pytest.mark.parametrize("ignore_failed", [False, True])
def test_metrics_match_jax(ignore_failed):
    mats = _random_traj()
    noisy = _noisy(mats)
    noisy[10] = noisy[9]          # a failed frame repeats its predecessor
    got = pmet.absolute_trajectory_error(mats, noisy, ret_align_T=True,
                                         ignore_failed_pos=ignore_failed)
    ref = jmet.absolute_trajectory_error(mats, noisy, ret_align_T=True,
                                         ignore_failed_pos=ignore_failed)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-12)
    for delta in (1, 3):
        for g, r in zip(pmet.relative_pose_error(mats, noisy, delta, ignore_failed),
                        jmet.relative_pose_error(mats, noisy, delta, ignore_failed)):
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-12)
    T = pmet.horn_align(mats[:, :3, 3].T, noisy[:, :3, 3].T)
    np.testing.assert_allclose(T, jmet.horn_align(mats[:, :3, 3].T,
                                                  noisy[:, :3, 3].T), atol=1e-12)
    assert pmet.total_trajectory_length(mats[:, :3, 3]) == pytest.approx(
        jmet.total_trajectory_length(mats[:, :3, 3]), abs=1e-12)


def test_evaluate_matches_jax(tmp_path):
    """tests/test_trajectory_metrics.py's end-to-end evaluation (files,
    timestamp offset) with a noisy prediction, and the CLI's printout."""
    mats = _random_traj(30)
    vecs = ptraj.mat2vec(mats)
    pvecs = ptraj.mat2vec(_noisy(mats, scale=0.5))
    gt = [{"camera-pose": v, "timestamp": i} for i, v in enumerate(vecs)]
    pred = [{"camera-pose": v, "timestamp": i - 4} for i, v in enumerate(pvecs)]
    ptraj.save_trajectory(gt, str(tmp_path), "gt.freiburg")
    ptraj.save_trajectory(pred, str(tmp_path), "pred.freiburg")
    args = (str(tmp_path / "gt.freiburg"), str(tmp_path / "pred.freiburg"))
    got = pev.evaluate(*args, delta=1, offset=4, ret_align_T=True)
    ref = jev.evaluate(*args, delta=1, offset=4, ret_align_T=True)
    assert len(got) == len(ref) == 9
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-12)
    assert pev.get_traj_length(*args, offset=4) == pytest.approx(
        jev.get_traj_length(*args, offset=4), abs=1e-12)
    assert pev.get_traj_length(args[0]) == jev.get_traj_length(args[0])
    with pytest.raises(ValueError, match="no overlapping"):
        pev.evaluate(*args, offset=1000)
    cli = [sys.executable, "-m", "{}.utils.evaluate", *args, "--offset", "4"]
    out = [subprocess.run([c.format(pkg) for c in cli], cwd=ROOT, check=True,
                          capture_output=True, text=True).stdout
           for pkg in ("robust_pose_tpu_torch", "robust_pose_tpu")]
    assert out[0] == out[1] and "absolute_translational_error.rmse" in out[0]


# --- stage timer, logger, configuration ---------------------------------------

def test_stage_timer_on_the_cpu():
    timer = StageTimer()
    for _ in range(3):
        with timer.stage("track", sync=[torch.ones(4), {"a": torch.zeros(2)}]):
            sum(range(1000))
    with timer.stage("readback"):
        pass
    s = timer.summary()
    assert set(s) == {"track", "readback"} and timer.counts["track"] == 3
    assert all(v >= 0 for v in s.values())
    assert timer.report().startswith("track: ") and "readback: " in timer.report()


def test_inference_logger_matches_jax():
    """The metric history of the port's InferenceLogger equals the JAX
    package's for the same poses (device tensors or host arrays), without
    wandb and without a scene."""
    mats = _random_traj(5)
    gt = ptraj.mat2vec(mats)
    pred = ptraj.mat2vec(_noisy(mats, scale=0.1)).astype(np.float32)
    got, ref = plog.InferenceLogger(log=None), jlog.InferenceLogger(log=None)
    got.set_gt(gt)
    ref.set_gt(gt)
    for i, v in enumerate(pred):
        got(None, torch.from_numpy(v), step=i)
        ref(None, v, step=i)
    assert got.history == ref.history and not got.enabled
    assert got.history[0]["surfels/total"] == 0 and "error/rot" in got.history[0]


def test_train_logger_prints_running_means(capsys):
    tl = plog.TrainLogger({}, log=False)
    for v in (1.0, 3.0):
        tl.push({"loss": v}, freq=2)
    tl.flush()
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("loss") and float(out[1].split(",")[0]) == 2.0


@pytest.mark.parametrize("name", sorted(p.name for p in (ROOT / "configuration")
                                        .glob("*.yaml")))
def test_read_yaml_equals_safe_load(name):
    path = ROOT / "configuration" / name
    assert read_yaml(str(path)) == yaml.safe_load(path.read_text())


def test_read_yaml_nesting_and_nulls(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("a:\n  b:\n    - 1\n    - x\n  c: 2.5e-3  # note\n"
                 "d:\ne: False\nf:\n  g: null\n")
    assert read_yaml(str(p)) == yaml.safe_load(p.read_text())
