"""The port's Lie group, geometry, warps, instance norm, convex upsampling
and LM solver against the JAX package on the CPU, at f32, on the same
numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_pose_tpu import se3 as jse3
from robust_pose_tpu.models.raft import upsample_flow_convex as j_upsample
from robust_pose_tpu.ops import geometry as jgeo
from robust_pose_tpu.ops import warp as jwarp
from robust_pose_tpu.ops.pallas_instance_norm import instance_norm as j_instance_norm
from robust_pose_tpu.solver.gauss_newton import SolverConfig as JSolverConfig
from robust_pose_tpu.solver.gauss_newton import solve_pose as j_solve_pose
from robust_pose_tpu.solver.objectives import objective as j_objective
from robust_pose_tpu_torch import se3
from robust_pose_tpu_torch.models.raft import upsample_flow_convex
from robust_pose_tpu_torch.ops import geometry, warp
from robust_pose_tpu_torch.ops.instance_norm import instance_norm
from robust_pose_tpu_torch.solver.gauss_newton import SolverConfig, solve_pose
from robust_pose_tpu_torch.solver.objectives import objective
from tests.test_torch_port_kernels import as_jax, as_port, solver_problem

T = torch.from_numpy


def _close(got, ref, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **kw)


# --- se3 ----------------------------------------------------------------------

def _tangents(seed=0):
    """Random tangents, including rotation angles below the small-angle
    thresholds (|w| < 1e-4) and a zero rotation."""
    rng = np.random.default_rng(seed)
    tau = rng.normal(0, 0.5, (16, 6)).astype(np.float32)
    tau[:4, 3:] *= 1e-5
    tau[4, 3:] = 0.0
    tau[5:8, 3:] *= 0.05            # below the 1e-2 theta^2 Taylor switch
    return tau


@pytest.mark.parametrize("op", ["exp", "log", "mul", "inv", "act", "retract",
                                "scale_normalize"])
def test_se3_matches_jax(op):
    """f32 atol 1e-6 (a few ulps of O(1) values)."""
    tau = _tangents()
    tau2 = _tangents(1)
    g, g2 = se3.exp(T(tau)), se3.exp(T(tau2))
    jg, jg2 = jse3.exp(jnp.asarray(tau)), jse3.exp(jnp.asarray(tau2))
    pts = np.random.default_rng(2).normal(size=(16, 3)).astype(np.float32)
    got, ref = {
        "exp": (g, jg),
        "log": (se3.log(g), jse3.log(jg)),
        "mul": (se3.mul(g, g2), jse3.mul(jg, jg2)),
        "inv": (se3.inv(g), jse3.inv(jg)),
        "act": (se3.act(g, T(pts)), jse3.act(jg, jnp.asarray(pts))),
        "retract": (se3.retract(T(tau2) * 0.1, g), jse3.retract(jnp.asarray(tau2) * 0.1, jg)),
        "scale_normalize": (se3.normalize(se3.scale(g * 1.01, 3.0)),
                            jse3.normalize(jse3.scale(jg * 1.01, 3.0))),
    }[op]
    _close(got, ref, rtol=1e-5, atol=1e-6)


def test_se3_identity_and_log_of_identity():
    ident = se3.identity((3,))
    _close(ident, jse3.identity((3,)), atol=0)
    _close(se3.log(ident), np.zeros((3, 6)), atol=0)


# --- geometry and warps -------------------------------------------------------

def _warp_inputs(seed=0, b=2, h=24, w=32):
    rng = np.random.default_rng(seed)
    K = np.tile(np.array([[40.0, 0, w / 2], [0, 42.0, h / 2], [0, 0, 1.0]],
                         np.float32)[None], (b, 1, 1))
    depth = rng.uniform(0.1, 1.0, (b, h, w, 1)).astype(np.float32)
    mask = rng.uniform(size=(b, h, w, 1)) > 0.3
    # flow mixes sub-pixel shifts, exact half-pixel ties and out-of-image targets
    flow = rng.normal(0, 3.0, (b, h, w, 2)).astype(np.float32)
    flow[:, ::3, ::2] = np.round(flow[:, ::3, ::2]) + 0.5
    flow[:, :2] -= 40.0
    return K, depth, mask, flow


def test_depth_to_pcl_matches_jax():
    K, depth, _, _ = _warp_inputs()
    h, w = depth.shape[1:3]
    with jax.default_matmul_precision("float32"):
        ref = jgeo.depth_to_pcl(jnp.asarray(depth), jnp.asarray(K),
                                jgeo.create_img_coords(h, w))
    got = geometry.depth_to_pcl(T(depth), T(K), geometry.create_img_coords(h, w))
    _close(got, ref, rtol=1e-6, atol=1e-6)
    _close(geometry.create_img_coords(h, w), jgeo.create_img_coords(h, w), atol=0)


def test_warp_pcl_mask_matches_jax():
    """Warped cloud to f32 rounding; the nearest-sampled mask bit-exact."""
    K, depth, mask, flow = _warp_inputs()
    ref_pcl, ref_mask = jwarp.warp_pcl_mask(jnp.asarray(depth), jnp.asarray(mask),
                                            jnp.asarray(flow), jnp.asarray(K))
    pcl, m = warp.warp_pcl_mask(T(depth), T(mask), T(flow), T(K))
    assert m.dtype == torch.bool
    np.testing.assert_array_equal(m.numpy(), np.asarray(ref_mask))
    _close(pcl, ref_pcl, rtol=1e-5, atol=1e-6)


def test_warp_then_eighth_and_eighth_from_fullres_match_jax():
    rng = np.random.default_rng(3)
    b, h, w = 2, 32, 48
    x = rng.normal(size=(b, h, w, 5)).astype(np.float32)
    flow = rng.normal(0, 4.0, (b, h, w, 2)).astype(np.float32)
    flow[0, :8] -= 30.0
    _close(warp.warp_then_eighth(T(x), T(flow)),
           jwarp.warp_then_eighth(jnp.asarray(x), jnp.asarray(flow)),
           rtol=1e-5, atol=1e-6)
    _close(warp.eighth_from_fullres_warp(T(x)),
           jwarp.eighth_from_fullres_warp(jnp.asarray(x)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_matches_jax(mode):
    rng = np.random.default_rng(4)
    img = rng.normal(size=(2, 12, 16, 3)).astype(np.float32)
    cx = rng.uniform(-3, 19, (2, 50)).astype(np.float32)
    cy = rng.uniform(-3, 15, (2, 50)).astype(np.float32)
    cx[:, :5] = np.floor(cx[:, :5]) + 0.5        # nearest ties
    _close(warp.grid_sample(T(img), T(cx), T(cy), mode),
           jwarp.grid_sample(jnp.asarray(img), jnp.asarray(cx), jnp.asarray(cy), mode),
           rtol=1e-6, atol=1e-6)


# --- instance norm and convex upsampling --------------------------------------

@pytest.mark.parametrize("c", [64, 256])
def test_instance_norm_matches_jax(c):
    """C <= 128 goes through the stats wrapper, C > 128 through plain means
    in both packages; f32 atol 1e-5 on unit-variance outputs."""
    rng = np.random.default_rng(c)
    x = rng.normal(1.0, 3.0, (2, 10, 14, c)).astype(np.float32)
    _close(instance_norm(T(x)), j_instance_norm(jnp.asarray(x)), rtol=1e-5, atol=1e-5)


def test_upsample_flow_convex_matches_jax():
    rng = np.random.default_rng(5)
    flow = rng.normal(0, 2.0, (2, 6, 7, 2)).astype(np.float32)
    mask = rng.normal(0, 2.0, (2, 6, 7, 576)).astype(np.float32)
    _close(upsample_flow_convex(T(flow), T(mask)),
           j_upsample(jnp.asarray(flow), jnp.asarray(mask)), rtol=1e-5, atol=1e-5)


# --- solver ---------------------------------------------------------------------

def _tangent_distance(a, b):
    rel = jse3.mul(jse3.inv(jnp.asarray(a)), jnp.asarray(b))
    return np.abs(np.asarray(jse3.log(rel))).max()


@pytest.mark.parametrize("early_exit", [True, False])
def test_solve_pose_matches_jax(early_exit):
    """Poses within 1e-5 tangent distance and EQUAL realized LM iteration
    counts (the JAX side on its f32 XLA normal equations at HIGHEST
    precision, the port on the kernel's plain version)."""
    p = solver_problem(b=3, h=32, w=48, seed=7)
    cfg = JSolverConfig(iters=15, early_exit=early_exit)
    with jax.default_matmul_precision("float32"):
        jpose, jtau, jn = jax.jit(lambda x: j_solve_pose(
            x, jgeo.create_img_coords(32, 48), cfg))(as_jax(p))
    pose, tau, n = solve_pose(as_port(p), SolverConfig(iters=15,
                                                      early_exit=early_exit))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    assert _tangent_distance(pose.numpy(), jpose) < 1e-5
    _close(tau, jtau, atol=1e-5)


def test_objective_matches_jax():
    p = solver_problem(b=2, h=32, w=48, seed=9)
    pose = np.asarray(jse3.exp(0.02 * jnp.ones((2, 6))))
    with jax.default_matmul_precision("float32"):
        ref = j_objective(as_jax(p), jnp.asarray(pose),
                          jgeo.create_img_coords(32, 48))
    got = objective(as_port(p), T(pose.copy()), geometry.create_img_coords(32, 48))
    _close(got, ref, rtol=1e-5)
