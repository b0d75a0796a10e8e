"""RAFT's small variant in the port against the JAX package on the CPU, f32,
with the same numpy-seeded weights: the whole RAFT pass under each lookup
route (the Pallas kernels in interpret mode where the JAX route reaches
them), the radius-3 lookups' plain versions against the Pallas kernels,
PoseNet inference, the bilinear 8x upsampling, and the radii the kernel
wrappers refuse."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robust_pose_tpu.ops.pallas_lookup as j_pallas_lookup
from robust_pose_tpu.models.posenet import PoseNet as JPoseNet
from robust_pose_tpu.models.raft import RAFT as JRAFT
from robust_pose_tpu.ops.pallas_corr_onthefly import (
    onthefly_lookup as j_onthefly_lookup,
    pool_fmap_pyramid as j_pool,
)
from robust_pose_tpu.ops.pallas_lookup_lanewise import (
    build_corr_pyramid_t as j_build_t,
    lanewise_lookup as j_lanewise_lookup,
)
from robust_pose_tpu_torch.models.posenet import PoseNet
from robust_pose_tpu_torch.models.raft import RAFT, upsample_flow_bilinear
from robust_pose_tpu_torch.ops import corr_lanewise as L
from robust_pose_tpu_torch.ops import corr_onthefly as K1
from tests.test_torch_port_common import jax_variables, random_state_dict

H, W = 64, 96


def _images(seed, n=2):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 255, (n, H, W, 3)).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("lookup", ["xla", "onthefly", "lanewise", "grouped"])
def test_small_raft_matches_jax(lookup, monkeypatch):
    """``RAFT(small=True)`` at 64x96, 2 iterations, f32, through each lookup
    route on both sides (JAX's "onthefly" and "lanewise" run their Pallas
    kernels in interpret mode on the CPU, its "grouped" is made to): flow
    atol 1e-4 px (|flow| up to ~14), hidden state and context atol 1e-5.
    Radius 3 everywhere but "grouped", whose Pallas lookup takes no radius:
    there the small model reads radius-4 windows and ``convc1`` takes
    4 x 81 channels, in both packages."""
    monkeypatch.setattr(
        j_pallas_lookup, "pallas_lookup_pyramid_grouped",
        functools.partial(j_pallas_lookup.pallas_lookup_pyramid_grouped,
                          interpret=True))
    port = RAFT(iters=2, dtype=torch.float32, corr_dtype=torch.float32,
                small=True, lookup=lookup).eval()
    cin = port.update["update_block"].encoder.convc1.weight.shape[1]
    assert cin == 4 * (81 if lookup == "grouped" else 49)
    sd = random_state_dict(port, seed=3)
    port.load_state_dict(sd)
    jmodel = JRAFT(iters=2, dtype=jnp.float32, corr_dtype=jnp.float32,
                   small=True, lookup=lookup)
    img1, img2 = _images(0)
    with jax.default_matmul_precision("float32"):
        ref = jmodel.apply(jax_variables(sd), jnp.asarray(img1), jnp.asarray(img2))
    with torch.no_grad():
        got = port(torch.from_numpy(img1), torch.from_numpy(img2))
    assert got[0].shape == (2, H, W, 2)
    assert got[1].shape == (2, H // 8, W // 8, 96)
    assert got[2].shape == (2, H // 8, W // 8, 64)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-4)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


def _grid_coords(b, h8, w8, rng):
    yg, xg = np.meshgrid(np.arange(h8, dtype=np.float32),
                         np.arange(w8, dtype=np.float32), indexing="ij")
    c = np.tile(np.stack([xg, yg], -1)[None], (b, 1, 1, 1))
    c = c + rng.normal(0, 2.0, c.shape)
    flat = c.reshape(b, -1, 2)
    flat[:, ::7] = flat[:, ::7] * 3.0 - 30.0     # windows partly or wholly off
    return c.astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_radius3_onthefly_matches_pallas(dtype):
    """K1's plain version at radius 3 through the pyramid entry (7 x 7 = 49
    values a level), against the Pallas kernel in interpret mode, all 4
    levels, N = 99 (no multiple of the tiles); atol 1e-5: the same exact
    f32 products of (bf16-representable) features, summed in other
    orders."""
    rng = np.random.default_rng(5)
    b, h8, w8, c = 2, 9, 11, 16
    f1, f2 = (rng.normal(size=(b, h8, w8, c)).astype(np.float32) for _ in range(2))
    coords = _grid_coords(b, h8, w8, rng)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    f1j = jnp.asarray(f1).astype(jdt)
    levels = [l.astype(jdt) for l in j_pool(jnp.asarray(f2))]
    ref = j_onthefly_lookup(f1j, levels, jnp.asarray(coords), radius=3,
                            interpret=True)
    as_t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
    before = K1.launches
    got = K1.onthefly_lookup_pyramid(as_t(f1j), [as_t(l) for l in levels],
                                     torch.from_numpy(coords), radius=3)
    assert K1.launches == before and len(got) == 4
    for lvl, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == (b, 49, h8 * w8)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-5,
                                   err_msg=f"level {lvl}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_radius3_lanewise_matches_pallas(dtype):
    """K4 and K5's plain versions at radius 3 through the pyramid entry,
    against the JAX package's ``lanewise_lookup`` (Pallas forward and
    backward kernels in interpret mode) with ``jax.vjp``: forward atol 1e-5;
    dcorr atol 1e-5 (rtol 2^-7 with a bf16 volume, rounded to bf16 once on
    each side); dcoords, summed over the 4 levels, atol 1e-5 of its
    largest."""
    rng = np.random.default_rng(7)
    b, h8, w8 = 2, 9, 11
    n = h8 * w8
    f1, f2 = (rng.normal(size=(b, h8, w8, 8)).astype(np.float32) for _ in range(2))
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    pj = j_build_t(jnp.asarray(f1), jnp.asarray(f2), dtype=jdt)
    coords = _grid_coords(b, h8, w8, rng)
    gs = [rng.normal(size=(b, 49, n)).astype(np.float32) for _ in pj]

    def run(pyr, cc, cts):
        out, vjp = jax.vjp(
            lambda p, c: j_lanewise_lookup(p, c, radius=3, interpret=True),
            pyr, cc)
        return out, vjp(cts)

    out_j, (dpyr_j, dco_j) = jax.jit(run)(pj, jnp.asarray(coords),
                                          [jnp.asarray(g) for g in gs])
    pyr = [torch.from_numpy(np.array(p.astype(jnp.float32))).to(tdt)
           .requires_grad_() for p in pj]
    c = torch.from_numpy(coords).requires_grad_()
    got = L.lanewise_lookup(pyr, c, radius=3)
    grads = torch.autograd.grad(got, pyr + [c], [torch.from_numpy(g) for g in gs])
    for lvl in range(len(pyr)):
        assert got[lvl].shape == (b, 49, n)
        np.testing.assert_allclose(got[lvl].detach().numpy(),
                                   np.asarray(out_j[lvl]), atol=1e-5,
                                   err_msg=f"forward, level {lvl}")
        np.testing.assert_allclose(
            grads[lvl].float().numpy(),
            np.asarray(dpyr_j[lvl].astype(jnp.float32)),
            rtol=2 ** -7 if dtype == "bf16" else 0, atol=1e-5,
            err_msg=f"dcorr, level {lvl}")
    ref = np.asarray(dco_j)
    np.testing.assert_allclose(grads[-1].numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max(), err_msg="dcoords")


def test_small_posenet_infer_matches_jax():
    """PoseNet with ``small: True`` and ``unet_levels`` 1 at 64x96 (weight
    heads of 168 and 176 input channels), ``infer`` on both sides from the
    same weights and inputs, f32: flows atol 1e-4 px, confidences atol
    1e-5, pose atol 1e-4, equal LM iteration counts."""
    cfg = {"image_shape": (H, W), "iters": 2, "lbgfs_iters": 5,
           "use_weights": True, "mixed_precision": False, "unet_levels": 1,
           "small": True, "lookup": "xla"}
    port = PoseNet(cfg, device="cpu")
    assert port.weight_head_2d.unet.enc0.conv1.in_channels == 168
    assert port.weight_head_3d.unet.enc0.conv1.in_channels == 176
    sd = random_state_dict(port, seed=9)
    head = "flow.update.update_block.flow_head.conv2."
    sd[head + "weight"] = 0.1 * sd[head + "weight"]
    sd[head + "bias"] = torch.tensor([-0.15, 0.0])
    port.load_state_dict(sd)
    rng = np.random.default_rng(2)
    img1, img2, img2r = (rng.uniform(0, 255, (1, H, W, 3)).astype(np.float32)
                         for _ in range(3))
    K = np.array([[[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1.0]]],
                 np.float32)
    bl = np.ones((1,), np.float32)
    depth1 = rng.uniform(0.3, 0.6, (1, H, W, 1)).astype(np.float32)
    mask = np.ones((1, H, W, 1), bool)
    sflow1 = np.zeros((1, H, W, 2), np.float32)
    args = (img1, img2, K, bl, depth1, img2r, mask, mask, sflow1)
    with jax.default_matmul_precision("float32"):
        ref = JPoseNet(cfg).apply(jax_variables(sd), *map(jnp.asarray, args),
                                  method=JPoseNet.infer)
    with torch.no_grad():
        got = port.infer(*map(torch.from_numpy, args))
    for name, tol in (("flow", 1e-4), ("stereo_flow2", 1e-4), ("conf1", 1e-5),
                      ("conf2", 1e-5), ("pose", 1e-4)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=tol,
                                   err_msg=name)
    assert np.array_equal(got.solver_iters.numpy(), np.asarray(ref.solver_iters))


@pytest.mark.parametrize("hw", [(8, 12), (5, 7)])
def test_bilinear_upsampling_matches_jax_resize(hw):
    """``8 * jax.image.resize(flow, "linear", antialias=False)`` against the
    port's ``F.interpolate`` (half-pixel centres): the border rows and
    columns, where jax renormalises the triangle kernel's weights inside
    the image and torch clamps the source coordinate, hold the edge value in
    both; every value within 1e-6 of the largest (torch's interpolation
    weights round differently from jax's normalised ones)."""
    h, w = hw
    flow = np.random.default_rng(h).normal(0, 3, (2, h, w, 2)).astype(np.float32)
    ref = np.asarray(8.0 * jax.image.resize(jnp.asarray(flow), (2, 8 * h, 8 * w, 2),
                                            method="linear", antialias=False))
    got = upsample_flow_bilinear(torch.from_numpy(flow)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    # the outer 4 rows (columns) sample at -7/16 .. -1/16 of a pixel (or as
    # far past the last one): all equal the edge row (column) of the input,
    # interpolated along the other axis only
    for side in (slice(0, 4), slice(-4, None)):
        for ax in (1, 2):
            edge = np.take(got, [side.start], axis=ax)
            np.testing.assert_allclose(got[(slice(None),) * ax + (side,)],
                                       np.repeat(edge, 4, ax), rtol=0,
                                       atol=1e-6 * np.abs(ref).max())
    np.testing.assert_allclose(got[:, 0, 0], 8.0 * flow[:, 0, 0], rtol=1e-6)


@pytest.mark.parametrize("entry", ["onthefly", "lanewise_fwd", "lanewise_bwd"])
def test_radius_5_is_refused(entry):
    """The kernels are built for radius 3 and 4; the wrappers refuse 5 by
    name on every device (here on CPU tensors, where the plain version
    alone would have taken it)."""
    f1 = torch.zeros(1, 4, 6, 8)
    coords = torch.zeros(1, 4, 6, 2)
    vol = torch.zeros(1, 4, 6, 24)
    with pytest.raises(ValueError, match="radius 5"):
        if entry == "onthefly":
            K1.onthefly_lookup_pyramid(f1, K1.pool_fmap_pyramid(f1, 2), coords,
                                       radius=5)
        elif entry == "lanewise_fwd":
            L.lanewise_lookup([vol], coords, radius=5)
        else:
            L.lanewise_bwd(vol, coords.reshape(1, 24, 2),
                           torch.zeros(1, 121, 24), 5, 1.0)
