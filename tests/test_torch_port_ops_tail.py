"""The port's small ops and host utilities on the CPU against the JAX
package: ``ops/image`` (Sobel gradients, batched dot product, batched
identity), ``ops/geometry.reproject``, the three warps of ``ops/warp``
(with the bilinear payload's gradients), ``ops/interpolation``,
``models/raft.lookup_corr_gather`` (against JAX's and against the port's
plain lookups), ``PoseNet.run_flow``, ``utils/pfm``, ``utils/opencv`` and
``utils/lib_handling``. Inputs come from numpy seeds.

Tolerances: nearest samples, validity masks, medians, the identity, the
interpolations' untouched pixels and PFM files are equal bit for bit;
``reproject`` is bit-equal too (K^-1 and the rays round as JAX's LU
inverse and HIGHEST product on the CPU); bilinear samples, lookups and
the convolutions within 1e-5 absolute on O(1) values (f32 sums in another
order); gradients within 1e-5 of the largest JAX gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_pose_tpu.models import raft as jraft
from robust_pose_tpu.ops import geometry as jgeo
from robust_pose_tpu.ops import image as jimage
from robust_pose_tpu.ops import interpolation as jinterp
from robust_pose_tpu.ops import warp as jwarp
from robust_pose_tpu_torch.models import raft as praft
from robust_pose_tpu_torch.ops import geometry as pgeo
from robust_pose_tpu_torch.ops import image as pimage
from robust_pose_tpu_torch.ops import interpolation as pinterp
from robust_pose_tpu_torch.ops import warp as pwarp

H, W = 24, 32
TOL = 1e-5


def rng(seed):
    return np.random.default_rng(seed)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


def same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# --- ops/image ----------------------------------------------------------------

def test_image_gradient_matches_jax():
    img = rng(0).normal(size=(2, 3, H, W)).astype(np.float32)
    got = pimage.image_gradient(torch.from_numpy(img))
    want = jimage.image_gradient(jnp.asarray(img))
    assert tuple(got.shape) == want.shape == (2, 6, H, W)
    close(got, want)


def test_batched_dot_product_and_beye_match_jax():
    r = rng(1)
    a, b = (r.normal(size=(3, 50, 4)).astype(np.float32) for _ in range(2))
    close(pimage.batched_dot_product(torch.from_numpy(a), torch.from_numpy(b)),
          jimage.batched_dot_product(jnp.asarray(a), jnp.asarray(b)))
    eye = pimage.beye(4, 3, dtype=torch.float64)
    assert eye.dtype == torch.float64
    same(eye, jimage.beye(4, 3, dtype=jnp.float32))


# --- ops/geometry.reproject ----------------------------------------------------

@pytest.mark.parametrize("layout", ["nchw", "nhwc", "flat"])
@pytest.mark.parametrize("batched_k", [True, False])
def test_reproject_matches_jax_bit_for_bit(layout, batched_k):
    """Every depth layout, per-sample and shared intrinsics; focal lengths
    and principal points drawn so that K^-1 has no exact entries."""
    r = rng(2)
    b = 3
    depth = r.uniform(0.1, 1.0, (b, H, W)).astype(np.float32)
    shaped = {"nchw": depth[:, None], "nhwc": depth[..., None],
              "flat": depth.reshape(b, -1)}[layout]
    ks = np.zeros((b, 3, 3), np.float32)
    ks[:, 0, 0], ks[:, 1, 1] = r.uniform(80, 120, b), r.uniform(80, 120, b)
    ks[:, 0, 2], ks[:, 1, 2] = r.uniform(10, 20, b), r.uniform(8, 16, b)
    ks[:, 2, 2] = 1.0
    k = ks if batched_k else ks[0]
    coords = np.array(jgeo.create_img_coords(H, W))
    got = pgeo.reproject(torch.from_numpy(shaped), torch.from_numpy(k),
                         torch.from_numpy(coords))
    want = jgeo.reproject(jnp.asarray(shaped), jnp.asarray(k), jnp.asarray(coords))
    assert tuple(got.shape) == want.shape == (b, H * W, 4)
    same(got, want)


# --- ops/warp -----------------------------------------------------------------

def warp_inputs(seed, c=3, cn=2):
    """Positive images (zeros in a corner so that validity has both
    values), a nearest payload, and flows of up to 6 px that send some
    pixels off the image and some exactly onto half-pixel positions."""
    r = rng(seed)
    x = r.uniform(0.0, 1.0, (2, H, W, c)).astype(np.float32)
    x[:, :4, :4] = 0.0
    nx = (r.uniform(0, 1, (2, H, W, cn)) > 0.5).astype(np.float32)
    flow = r.uniform(-6.0, 6.0, (2, H, W, 2)).astype(np.float32)
    flow[:, ::5, ::3] = np.round(flow[:, ::5, ::3]) + 0.5
    return x, nx, flow


def test_warp_bilinear_nearest_matches_jax():
    x, nx, flow = warp_inputs(3)
    got = pwarp.warp_bilinear_nearest(*map(torch.from_numpy, (x, nx, flow)))
    want = jwarp.warp_bilinear_nearest(*map(jnp.asarray, (x, nx, flow)))
    close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        same(g, w)
    assert got[1].dtype == got[3].dtype == torch.bool
    none = pwarp.warp_bilinear_nearest(torch.from_numpy(x), None,
                                       torch.from_numpy(flow))
    assert none[2] is None and none[3] is None
    same(none[0], got[0])


@pytest.mark.parametrize("which", ["bilinear", "nearest"])
def test_remap_from_flow_matches_jax(which):
    x, _, flow = warp_inputs(4)
    pfn = {"bilinear": pwarp.remap_from_flow,
           "nearest": pwarp.remap_from_flow_nearest}[which]
    jfn = {"bilinear": jwarp.remap_from_flow,
           "nearest": jwarp.remap_from_flow_nearest}[which]
    got = pfn(torch.from_numpy(x), torch.from_numpy(flow))
    want = jfn(jnp.asarray(x), jnp.asarray(flow))
    (close if which == "bilinear" else same)(got[0], want[0])
    same(got[1], want[1])


def test_warp_gradients_match_jax():
    """Gradients of a weighted sum of the bilinear output with respect to
    the payload and the flow, and of the nearest output with respect to
    its payload (it rides the same corners)."""
    x, nx, flow = warp_inputs(5)
    wb = rng(6).normal(size=(2, H, W, 3)).astype(np.float32)
    wn = rng(7).normal(size=(2, H, W, 2)).astype(np.float32)

    def jloss(x, nx, flow):
        out, _, near, _ = jwarp.warp_bilinear_nearest(x, nx, flow)
        return jnp.sum(out * wb) + jnp.sum(near * wn)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, nx, flow)))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, nx, flow)]
    out, _, near, _ = pwarp.warp_bilinear_nearest(*args)
    (torch.sum(out * torch.from_numpy(wb))
     + torch.sum(near * torch.from_numpy(wn))).backward()
    for a, w in zip(args, want):
        close(a.grad, w, TOL * float(jnp.abs(w).max()))


# --- ops/interpolation ----------------------------------------------------------

def holes(seed, c=2):
    """A smooth image with NaN holes (some on the border)."""
    r = rng(seed)
    x = r.uniform(0.0, 1.0, (2, H, W, c)).astype(np.float32)
    x[r.uniform(size=x.shape) < 0.2] = np.nan
    x[:, 0, :3] = np.nan
    return x


@pytest.mark.parametrize("size,sigma", [(5, 2.0), (3, 1.0), (7, 3.5)])
def test_gauss_kernel_matches_jax(size, sigma):
    close(pinterp._gauss_kernel_2d(size, sigma),
          jinterp._gauss_kernel_2d(size, sigma), 1e-7)


@pytest.mark.parametrize("size,sigma", [(5, 2.0), (3, 1.0)])
def test_sparse_img_interpolate_matches_jax(size, sigma):
    x = holes(8)
    got = pinterp.sparse_img_interpolate(torch.from_numpy(x), size, sigma, 0.5)
    want = jinterp.sparse_img_interpolate(jnp.asarray(x), size, sigma, 0.5)
    close(got, want)
    keep = ~np.isnan(x)
    same(got.numpy()[keep], x[keep])
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("size", [2, 3, 4, 5])
def test_median_filter_matches_jax_bit_for_bit(size):
    x = rng(9).normal(size=(2, H, W, 3)).astype(np.float32)
    same(pinterp.median_filter_2d(torch.from_numpy(x), size),
         jinterp.median_filter_2d(jnp.asarray(x), size))


@pytest.mark.parametrize("size", [2, 3, 4, 5])
def test_sparse_median_interpolate_matches_jax_bit_for_bit(size):
    x = holes(10)
    got = pinterp.sparse_median_interpolate(torch.from_numpy(x), size, 0.25)
    same(got, jinterp.sparse_median_interpolate(jnp.asarray(x), size, 0.25))


# --- models/raft.lookup_corr_gather ---------------------------------------------

def gather_inputs(seed, dtype):
    r = rng(seed)
    h, w = 8, 12
    fm = [r.normal(size=(2, h, w, 16)).astype(np.float32) for _ in range(2)]
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(h), indexing="xy"),
                      -1)[None].astype(np.float32)
    coords = coords + r.uniform(-3.0, 3.0, (2, h, w, 2)).astype(np.float32)
    pyr = praft.build_corr_pyramid(*map(torch.from_numpy, fm), dtype=dtype)
    return fm, coords, pyr


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lookup_corr_gather_matches_jax(dtype):
    """The same volumes (the port's pyramid, handed to JAX) give the same
    windows; bf16 volumes promote to f32 in both."""
    _, coords, pyr = gather_inputs(11, dtype)
    got = praft.lookup_corr_gather(pyr, torch.from_numpy(coords))
    jpyr = [jnp.asarray(p.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32) for p in pyr]
    want = jraft.lookup_corr_gather(jpyr, jnp.asarray(coords))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    close(got, want)


def test_lookup_corr_gather_matches_the_port_lookups():
    """The oracle against the port's one-hot lookup (``"xla"``) and its
    bilinear grid_sample semantics, level by level (dy-major windows)."""
    _, coords, pyr = gather_inputs(12, torch.float32)
    got = praft.lookup_corr_gather(pyr, torch.from_numpy(coords))
    b, h, w, _ = coords.shape
    plain = torch.cat([lv.transpose(1, 2) for lv in
                       praft.lookup_corr(pyr, torch.from_numpy(coords))], -1)
    close(got, plain.reshape(b, h, w, -1))


# --- PoseNet.run_flow -------------------------------------------------------------

def test_run_flow_matches_jax_and_feeds_flow2depth():
    from robust_pose_tpu.models.posenet import PoseNet as JPoseNet
    from robust_pose_tpu_torch.models.posenet import PoseNet
    from tests.test_torch_port_common import jax_variables, random_state_dict

    h, w = 64, 96
    cfg = {"image_shape": (h, w), "iters": 2, "unet_levels": 1,
           "mixed_precision": False}
    model = PoseNet(cfg, device="cpu")
    sd = random_state_dict(model, 13)
    model.load_state_dict(sd)
    r = rng(14)
    i1, i2 = (r.uniform(0, 255, (1, h, w, 3)).astype(np.float32) for _ in range(2))
    with torch.no_grad():
        got = model.run_flow(torch.from_numpy(i1), torch.from_numpy(i2))
        depth = model.flow2depth(torch.from_numpy(i1), torch.from_numpy(i2),
                                 torch.ones(1))
    jm = JPoseNet(cfg)
    want = jm.apply(jax_variables(sd), jnp.asarray(i1), jnp.asarray(i2),
                    method=jm.run_flow)
    for g, x in zip(got, want):
        close(g, x, 1e-3 * max(1.0, float(jnp.abs(x).max())))
    same(depth[2], got[0])
    same(depth[0], PoseNet.disparity_to_depth(got[0], torch.ones(1))[0])


# --- utils -------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 1), (5, 7, 3)])
@pytest.mark.parametrize("scale", [1, 2.5])
def test_pfm_files_byte_equal_and_round_trip(tmp_path, shape, scale):
    from robust_pose_tpu.utils import pfm as jpfm
    from robust_pose_tpu_torch.utils import pfm as ppfm

    img = rng(15).normal(size=shape).astype(np.float32)
    ppfm.save_pfm(img, str(tmp_path / "port.pfm"), scale=scale)
    jpfm.save_pfm(img, str(tmp_path / "jax.pfm"), scale=scale)
    assert (tmp_path / "port.pfm").read_bytes() == (tmp_path / "jax.pfm").read_bytes()
    got, s = ppfm.load_pfm(str(tmp_path / "port.pfm"))
    want, js = jpfm.load_pfm(str(tmp_path / "jax.pfm"))
    same(got, want)
    assert s == js == abs(scale)
    if scale == 1:
        same(got, img.reshape(got.shape))


def test_pfm_refuses_other_files(tmp_path):
    from robust_pose_tpu_torch.utils import pfm as ppfm

    (tmp_path / "x.pfm").write_bytes(b"P6\n1 1\n255\n\0\0\0")
    with pytest.raises(ValueError, match="not a PFM"):
        ppfm.load_pfm(str(tmp_path / "x.pfm"))
    with pytest.raises(ValueError, match="dims"):
        ppfm.save_pfm(np.zeros((2, 2, 2)), str(tmp_path / "y.pfm"))


def test_opencv_keypoints_match_jax():
    import cv2

    from robust_pose_tpu.utils import opencv as jcv
    from robust_pose_tpu_torch.utils import opencv as pcv

    pts = rng(16).uniform(0, 100, (6, 2))
    kps = pcv.npy2kpts(pts)
    assert all(isinstance(k, cv2.KeyPoint) and k.size == 1.0 for k in kps)
    same(pcv.kpts2npy(kps), jcv.kpts2npy(jcv.npy2kpts(pts)))
    np.testing.assert_allclose(pcv.kpts2npy(kps), pts, rtol=1e-6)


def test_lib_handling_pairs_numpy_with_torch():
    from robust_pose_tpu_torch.utils.lib_handling import get_class, get_lib

    a = np.arange(3.0)
    t = torch.arange(3, dtype=torch.float64)
    assert get_lib(a) is np and get_lib(t) is torch
    assert get_class(a) is np.array
    made = get_class(t)([1, 2])
    assert isinstance(made, torch.Tensor) and made.dtype == torch.float64
    for bad in ([1.0], jnp.ones(2)):
        with pytest.raises(TypeError, match="not supported"):
            get_lib(bad)
        with pytest.raises(TypeError, match="not supported"):
            get_class(bad)
