"""The port's streaming bench (``robust_pose_tpu_torch.scripts.bench``) on
the CPU against the root ``bench.py``: ``make_sequence`` bit for bit;
``bench_stream`` on the port's estimator and on the JAX ``PoseEstimator``
built by bench.py's own recipe, with the same weights (``params_from_jax``
of the JAX estimator's variables), at 64x96 in f32 with one UNet level and
5 LM iterations, one timed window of 2 frames, f2f and f2m, early exit on
and off; and ``main`` printing bench.py's one JSON line.

Tolerances: success rates equal; the last window's poses within 1e-4
tangent distance at the 1/250 depth scale (``tests/test_torch_port_cli.py``'s
bound). The realized LM iterations are compared by their bounds only:
on this converged synthetic sequence the solver sits in the f32 noise
regime, where accepting a trial follows the last bits of its cost, and
the JAX package's own counts move between 3 and 20 when the frames move
by 1e-3 grey levels. Both packages count them alike: per sample, the
iterations run while not done (``solver/gauss_newton.solve_pose``).
"""
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robust_pose_tpu.models.posenet as jposenet
import robust_pose_tpu.slam.pose_estimator  # noqa: F401  (binds the flax PoseNet)
from robust_pose_tpu import se3 as jse3
from robust_pose_tpu_torch.scripts import bench as pbench
from robust_pose_tpu_torch.utils.convert import params_from_jax

H, W = 64, 96
LM_ITERS = 5
POSE_TOL = 1e-4
KEYS = {"metric", "value", "unit", "vs_baseline", "f2m_fps_iters100",
        "f2f_success_rate", "f2m_success_rate", "f2f_lm_iters", "f2m_lm_iters",
        "f2f_fps_noearlyexit", "f2f_fps_diagnostics",
        "f2f_fps_diagnostics_nofetch", "d2h_MBps", "f2m_fps_noearlyexit",
        "f2m_fps_iters20_noearlyexit"}
SLAM = {
    "f2f": {"frame2frame": True, "lbgfs_iters": LM_ITERS, "conf_weighing": True,
            "depth_clipping": [1, 250], "dist_thr": 0.05, "average_pts": False},
    "f2m": {"frame2frame": False, "lbgfs_iters": LM_ITERS,
            "conf_weighing": True, "depth_clipping": [1, 250],
            "dist_thr": 0.05, "average_pts": False, "map_capacity": 4 * H * W,
            "initial_bucket": 4 * H * W, "winner": "segsort"},
}
SEED0 = {"f2f": 1, "f2m": 11}


def _root_bench():
    """The root ``bench.py``. Importing it points the process's JAX
    compilation cache at $JAX_COMPILATION_CACHE_DIR, so that is set to the
    directory already in force: the worker's cache stays as it was. With
    JAX_PLATFORMS=cpu it skips its wait for an accelerator."""
    old = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    os.environ["JAX_COMPILATION_CACHE_DIR"] = jax.config.jax_compilation_cache_dir
    try:
        return importlib.import_module("bench")
    finally:
        if old is None:
            del os.environ["JAX_COMPILATION_CACHE_DIR"]
        else:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = old


jbench = _root_bench()


@pytest.fixture()
def small(monkeypatch):
    """Both benches at 64x96; the port's model in f32 with one UNet level
    (the 3-level TinyUNet needs ~384x512), and JAX's the same: bench.py's
    ``build_estimator`` has no key for them, so the flax PoseNet it makes
    gets them added to its config (the dict the checkpoint carries too)."""
    for mod in (jbench, pbench):
        monkeypatch.setattr(mod, "H", H)
        monkeypatch.setattr(mod, "W", W)
    monkeypatch.setattr(pbench, "MODEL", dict(pbench.MODEL, unet_levels=1,
                                              mixed_precision=False))
    flax_posenet = jposenet.PoseNet

    def posenet(cfg, *a, **kw):
        cfg.update(unet_levels=1, mixed_precision=False)
        return flax_posenet(cfg, *a, **kw)

    monkeypatch.setattr(jposenet, "PoseNet", posenet)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,disparity,step,seed", [
    (1, 8, 3, 0), (8, 8, 3, 1), (3, 16, 6, 11), (2, 5, 1, 7)])
def test_make_sequence_matches_root_bench_bit_for_bit(n, disparity, step, seed):
    got = pbench.make_sequence(n, disparity, step, seed)
    want = jbench.make_sequence(n, disparity, step, seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint8 and g.shape == (n, 1, 512, 640, 3)
        np.testing.assert_array_equal(g, w)


def _tangent_distance(a, b):
    a, b = (jse3.scale(jnp.asarray(np.asarray(x), jnp.float32).reshape(-1, 7),
                       1.0 / 250.0) for x in (a, b))
    return float(np.abs(np.asarray(jse3.log(jse3.mul(jse3.inv(a), b)))).max())


@pytest.mark.parametrize("early_exit", [True, False], ids=["exit", "noexit"])
@pytest.mark.parametrize("mode", ["f2f", "f2m"])
def test_bench_stream_matches_root_bench(small, mode, early_exit):
    je = jbench.build_estimator(dict(SLAM[mode]), early_exit=early_exit)
    _, j_ok, j_iters = jbench.bench_stream(je, t_window=2, n_windows=1,
                                           seed0=SEED0[mode])
    pe = pbench.build_estimator(dict(SLAM[mode]), early_exit=early_exit,
                                state_dict=params_from_jax(je.variables),
                                device="cpu")
    fps, p_ok, p_iters = pbench.bench_stream(pe, t_window=2, n_windows=1,
                                             seed0=SEED0[mode])
    assert np.isfinite(fps) and fps > 0
    assert p_ok == j_ok
    assert pe.model_config["solver_early_exit"] is early_exit
    for it in (p_iters, j_iters):
        assert set(it) == {"mean", "max", "min"}
        assert 1 <= it["min"] <= it["mean"] <= it["max"] <= LM_ITERS
    assert _tangent_distance(pe.last_pose, je.last_pose) <= POSE_TOL


def test_main_prints_bench_keys_on_the_cpu(small, monkeypatch, capsys):
    """``main --device cpu`` at 64x96 with windows of 2 frames: one JSON
    line with every key of bench.py's, finite positive FPS, rates in
    [0, 1], realized iterations within the caps 20 and 100."""
    monkeypatch.setattr(pbench, "F2F_WINDOW", 2)
    monkeypatch.setattr(pbench, "F2M_WINDOW", 2)
    stream = pbench.bench_stream
    monkeypatch.setattr(pbench, "bench_stream", lambda est, t_window, n_windows, **kw:
                        stream(est, t_window, 1, **kw))
    out = pbench.main(["--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1 and json.loads(lines[0]) == out
    assert set(out) == KEYS
    assert out["metric"] == "stereomis_tracking_fps_512x640_streaming"
    assert out["unit"] == "frames/s"
    assert abs(out["vs_baseline"] - out["value"] / 30.0) <= 1e-3
    for k in KEYS:
        if "fps" in k or k in ("value", "d2h_MBps"):
            assert np.isfinite(out[k]) and out[k] > 0, k
    for k in ("f2f_success_rate", "f2m_success_rate"):
        assert 0.0 <= out[k] <= 1.0
    assert out["f2f_lm_iters"]["max"] <= 20 and out["f2m_lm_iters"]["max"] <= 100
