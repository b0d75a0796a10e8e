"""The port's exact_render A/B and profile command lines on the CPU.

``scripts/ab_exact_render.py``: at 64x96 over 3 windows of 1 frame (f32,
one UNet level), each mode's poses against the JAX script's
``run_mode`` under the same ``exact_render`` (the root ``bench.py``'s
estimator, the same weights through ``params_from_jax``), within 1e-4
tangent distance at the 1/250 depth scale; ``main --device cpu`` prints
the comparison with no FPS. The profile tools parse the JAX scripts'
flags and, on the CPU, refuse to print device times.
"""
import importlib
import importlib.util
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robust_pose_tpu.models.posenet as jposenet
import robust_pose_tpu.slam.pose_estimator  # noqa: F401  (binds the flax PoseNet)
from robust_pose_tpu import se3 as jse3
from robust_pose_tpu_torch.scripts import ab_exact_render as pab
from robust_pose_tpu_torch.scripts import bench as pbench
from robust_pose_tpu_torch.utils.convert import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
H, W = 64, 96
N_WINDOWS, T_WINDOW = 3, 1


def _root_module(name, path=None):
    """A root module (``bench``) or script by path; the root ``bench.py``
    points JAX's compilation cache at $JAX_COMPILATION_CACHE_DIR, so that
    is set to the directory already in force."""
    old = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    os.environ["JAX_COMPILATION_CACHE_DIR"] = jax.config.jax_compilation_cache_dir
    try:
        if path is None:
            return importlib.import_module(name)
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    finally:
        if old is None:
            del os.environ["JAX_COMPILATION_CACHE_DIR"]
        else:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = old


jbench = _root_module("bench")
jab = _root_module("jax_ab_exact_render", ROOT / "scripts" / "ab_exact_render.py")


@pytest.fixture(scope="module")
def runs():
    """Both packages at 64x96 (f32, one UNet level on both sides: the JAX
    bench's flax PoseNet gets them added to its config), each mode's
    replayed poses, the port's from the JAX script's weights."""
    mp = pytest.MonkeyPatch()
    for mod in (jbench, pbench):
        mp.setattr(mod, "H", H)
        mp.setattr(mod, "W", W)
    mp.setattr(pbench, "MODEL", dict(pbench.MODEL, unet_levels=1,
                                     mixed_precision=False))
    flax_posenet = jposenet.PoseNet

    def posenet(cfg, *a, **kw):
        cfg.update(unet_levels=1, mixed_precision=False)
        return flax_posenet(cfg, *a, **kw)

    mp.setattr(jposenet, "PoseNet", posenet)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    made = []                 # the JAX script's estimators: their weights
    build = jbench.build_estimator
    mp.setattr(jbench, "build_estimator",
               lambda *a, **kw: made.append(build(*a, **kw)) or made[-1])
    try:
        out = {}
        for exact in (True, False):
            j = jab.run_mode(exact, N_WINDOWS, T_WINDOW)[0]
            sd = params_from_jax(made[0].variables)
            out[exact] = {"jax": j, "port": pab.run_mode(
                exact, N_WINDOWS, T_WINDOW, "cpu", sd)[0]}
        yield out
    finally:
        torch.set_num_threads(n)
        mp.undo()


def _tangent_distance(a, b):
    a, b = (jse3.scale(jnp.asarray(np.asarray(x), jnp.float32).reshape(-1, 7),
                       1.0 / 250.0) for x in (a, b))
    return float(np.abs(np.asarray(jse3.log(jse3.mul(jse3.inv(a), b)))).max())


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "packed"])
def test_each_mode_tracks_as_the_jax_script(runs, exact):
    p, j = runs[exact]["port"], runs[exact]["jax"]
    assert p.shape == j.shape == (N_WINDOWS * T_WINDOW, 7)
    assert np.isfinite(p).all()
    assert _tangent_distance(p, j) <= 1e-4


def test_comparison_matches_the_jax_scripts(runs):
    """The ATE between the modes and the largest pose-vector divergence,
    from the port's poses, within 1e-4 of the same figures of the JAX
    script's poses (its metrics on its own se3)."""
    from robust_pose_tpu.se3 import matrix as jmatrix
    from robust_pose_tpu.utils.metrics import absolute_trajectory_error

    ate, delta = pab.compare(runs[True]["port"], runs[False]["port"])
    jon, joff = runs[True]["jax"], runs[False]["jax"]
    jate, _ = absolute_trajectory_error(np.asarray(jmatrix(jnp.asarray(jon))),
                                        np.asarray(jmatrix(jnp.asarray(joff))))
    assert abs(ate - float(jate)) <= 1e-4
    assert abs(delta - float(np.abs(jon - joff).max())) <= 1e-4


def test_main_on_the_cpu_prints_no_fps(monkeypatch, capsys):
    monkeypatch.setattr(pbench, "H", H)
    monkeypatch.setattr(pbench, "W", W)
    monkeypatch.setattr(pbench, "MODEL", dict(pbench.MODEL, unet_levels=1,
                                              mixed_precision=False))
    out, vec_on, vec_off = pab.main(["--device", "cpu", "--windows",
                                     str(N_WINDOWS), "--window", str(T_WINDOW)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert out["fps_exact_on"] is None and out["fps_exact_off"] is None
    assert out["device"] is None and out["frames"] == N_WINDOWS * T_WINDOW
    assert np.isfinite(vec_on).all() and np.isfinite(vec_off).all()
    assert out["max_pose_vec_delta"] == float(np.abs(vec_on - vec_off).max())
    assert (out["ate_rmse_between_modes"], out["max_pose_vec_delta"]) == \
        pab.compare(vec_on, vec_off)


# each profile tool, the JAX script's flags (and --device), and the values
# they parse to
FLAGS = {
    "profile_trace": (["--path", "f2m", "--window", "4", "--windows", "3",
                       "--top", "5", "--json", "out.json"],
                      {"path": "f2m", "window": 4, "windows": 3, "top": 5,
                       "json": "out.json"}),
    "profile_stages": (["--iters", "3", "--stage", "flow", "--window", "4"],
                       {"iters": 3, "stage": "flow", "window": 4}),
    "profile_f2m": (["--frames", "2", "--iters", "1", "--stage", "solve"],
                    {"frames": 2, "iters": 1, "stage": "solve"}),
    "profile_encoder": (["--iters", "2", "--batches", "1", "16"],
                        {"iters": 2, "batches": [1, 16]}),
}


@pytest.mark.parametrize("tool", sorted(FLAGS))
def test_profile_tools_parse_flags_and_refuse_the_cpu(tool):
    mod = importlib.import_module(f"robust_pose_tpu_torch.scripts.{tool}")
    argv, want = FLAGS[tool]
    args = mod.build_parser().parse_args(argv)
    assert {k: getattr(args, k) for k in want} == want
    assert mod.build_parser().parse_args([]).device is None
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        mod.main(argv + ["--device", "cpu"])
