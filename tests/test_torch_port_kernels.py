"""The plain versions of the port's three kernels against the Pallas kernels
they replace, run in interpret mode on the CPU (the same inputs, made with
numpy, go to both). On a CPU tensor each kernel wrapper takes its plain
version, which is what is compared here; the CUDA kernels are compared
with these plain versions on the card by chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_pose_tpu import se3 as jse3
from robust_pose_tpu.ops.pallas_corr_onthefly import (
    onthefly_lookup as j_onthefly_lookup,
    pool_fmap_pyramid as j_pool,
)
from robust_pose_tpu.ops.pallas_instance_norm import instance_norm_stats as j_stats
from robust_pose_tpu.ops.pallas_normal_eq import (
    normal_equations_pallas,
    pack_planes as j_pack_planes,
)
from robust_pose_tpu.solver.objectives import PoseProblemInputs as JInputs
from robust_pose_tpu_torch import se3
from robust_pose_tpu_torch.ops import corr_onthefly, instance_norm, normal_eq
from robust_pose_tpu_torch.ops.geometry import create_img_coords
from robust_pose_tpu_torch.solver.objectives import PoseProblemInputs


# --- K1: correlation window lookup ------------------------------------------

def _base_coords(b, h, w):
    yg, xg = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    return np.tile(np.stack([xg, yg], -1)[None], (b, 1, 1, 1))


@pytest.mark.parametrize("case", ["shifted", "out_of_bounds", "ragged"])
def test_corr_lookup_plain_matches_pallas(case):
    """All 4 levels, f32, dy-major (B, 81, N) per level. Tolerance atol
    1e-5: both sum 8-channel f32 dot products, in different orders."""
    rng = np.random.default_rng(0)
    b, h8, w8, c = (1, 10, 9, 8) if case == "ragged" else (2, 16, 24, 8)
    f1 = rng.normal(size=(b, h8, w8, c)).astype(np.float32)
    f2 = rng.normal(size=(b, h8, w8, c)).astype(np.float32)
    base = _base_coords(b, h8, w8)
    coords = {"shifted": base + np.float32([3.3, -2.7]),
              "out_of_bounds": base * 3.0 - 50.0,
              "ragged": base + 0.4}[case].astype(np.float32)
    ref = j_onthefly_lookup(jnp.asarray(f1), j_pool(jnp.asarray(f2)),
                            jnp.asarray(coords), interpret=True)
    got = corr_onthefly.onthefly_lookup(
        torch.from_numpy(f1), corr_onthefly.pool_fmap_pyramid(torch.from_numpy(f2)),
        torch.from_numpy(coords))
    assert len(got) == 4
    for lvl, (g, r) in enumerate(zip(got, ref)):
        assert tuple(g.shape) == (b, 81, h8 * w8) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-5,
                                   err_msg=f"level {lvl}")


def test_pool_fmap_pyramid_matches_jax():
    rng = np.random.default_rng(1)
    f2 = rng.normal(size=(2, 13, 22, 8)).astype(np.float32)   # odd sizes: floor
    ref = j_pool(jnp.asarray(f2))
    got = corr_onthefly.pool_fmap_pyramid(torch.from_numpy(f2))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


# --- K2: instance-norm statistics -------------------------------------------

@pytest.mark.parametrize("c", [64, 96, 128])
def test_instance_norm_stats_plain_matches_pallas(c):
    """(2, 16, 24, C) f32; rtol 1e-5 for the different summation order."""
    rng = np.random.default_rng(c)
    x = rng.normal(0.5, 2.0, size=(2, 16, 24, c)).astype(np.float32)
    s_ref, ss_ref = j_stats(jnp.asarray(x), True)
    s, ss = instance_norm.instance_norm_stats(torch.from_numpy(x))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ss.numpy(), np.asarray(ss_ref), rtol=1e-5)


def test_instance_norm_stats_rejects_wide_channels():
    with pytest.raises(ValueError):
        instance_norm.instance_norm_stats(torch.zeros(1, 2, 2, 129))


# --- K3: normal equations ---------------------------------------------------

def solver_problem(b=2, h=32, w=48, seed=0, sigma=0.02):
    """numpy solver inputs: a depth map's cloud, the flow and 3D targets
    induced by random small poses (plus noise), random weights and masks."""
    rng = np.random.default_rng(seed)
    K = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1.0]], np.float32)
    K = np.tile(K[None], (b, 1, 1))
    depth = rng.uniform(0.3, 1.0, (b, h, w, 1)).astype(np.float32)
    coords = create_img_coords(h, w).numpy()
    rays = coords @ np.linalg.inv(K[0]).T
    pcl1 = (depth.reshape(b, -1, 1) * rays[None]).astype(np.float32)
    pose = se3.exp(torch.from_numpy(
        rng.normal(0, sigma, (b, 6)).astype(np.float32))).numpy()
    pp = se3.act(torch.from_numpy(pose)[:, None], torch.from_numpy(pcl1)).numpy()
    proj = pp @ K.transpose(0, 2, 1)
    flow = proj[..., :2] / proj[..., 2:] - coords[None, :, :2]
    flow = flow + rng.normal(0, 0.3, flow.shape)
    pcl2 = pp + rng.normal(0, 0.01, pp.shape)
    arr = lambda a, c: a.reshape(b, h, w, c).astype(np.float32)
    return dict(
        flow=arr(flow, 2), pcl1=arr(pcl1, 3), pcl2=arr(pcl2, 3),
        weights1=rng.uniform(0, 1, (b, h, w, 1)).astype(np.float32),
        weights2=rng.uniform(0, 1, (b, h, w, 1)).astype(np.float32),
        mask1=rng.uniform(size=(b, h, w, 1)) > 0.1,
        mask2=rng.uniform(size=(b, h, w, 1)) > 0.2,
        intrinsics=K, loss_weight=np.tile(np.float32([[0.5, 1.5]]), (b, 1)))


def as_port(p):
    return PoseProblemInputs(**{k: torch.from_numpy(np.asarray(v))
                                for k, v in p.items()})


def as_jax(p):
    return JInputs(**{k: jnp.asarray(v) for k, v in p.items()})


@pytest.mark.parametrize("shape", [(32, 48), (20, 30)])
def test_normal_equations_plain_matches_pallas(shape):
    """B = 2 at a random pose with random masks and weights; (20, 30) also
    exercises the padding of a pixel count that is no multiple of 2048.
    rtol 1e-4 of max |H| (f32 sums over ~1.5k pixels in different orders)."""
    h, w = shape
    p = solver_problem(h=h, w=w, seed=h)
    pose = np.asarray(jse3.exp(0.03 * jnp.ones((2, 6))))
    planes_j, kvec_j = j_pack_planes(as_jax(p), h, w)
    planes, kvec = normal_eq.pack_planes(as_port(p), h, w)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(planes_j))
    with jax.default_matmul_precision("float32"):
        H_r, g_r, c_r = normal_equations_pallas(
            jnp.asarray(pose), planes_j, kvec_j, jnp.asarray(p["loss_weight"]),
            h, w, interpret=True)
    H, g, cost = normal_eq.normal_equations(
        torch.from_numpy(pose), planes, kvec, torch.from_numpy(p["loss_weight"]),
        h, w)
    scale = float(np.abs(np.asarray(H_r)).max())
    np.testing.assert_allclose(H.numpy(), np.asarray(H_r), rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_r), rtol=1e-4,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(cost.numpy(), np.asarray(c_r), rtol=1e-4)
