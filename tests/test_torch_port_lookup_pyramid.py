"""The one-launch pyramid entries of the port's per-query lookup (K6
``pixel_lookup_pyramid``, K7 ``grouped_lookup_pyramid``) on the CPU, where
the wrappers take the plain version: the returned levels are views of one
buffer that RAFT's motion encoder takes as they are; the results match the
JAX package's Pallas lookups (interpret mode) at shapes that the kernels'
tiles of 32 and 8 queries make ragged; and the wrappers refuse, by name,
what the kernels do not take."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robust_pose_tpu.ops.pallas_lookup as j_pallas_lookup
from robust_pose_tpu_torch.models.raft import SplitConv1x1
from robust_pose_tpu_torch.ops import corr_pixel

PYRAMIDS = {"K6": corr_pixel.pixel_lookup_pyramid,
            "K7": corr_pixel.grouped_lookup_pyramid}
LEVELS = {"K6": corr_pixel.pixel_lookup_level,
          "K7": corr_pixel.grouped_lookup_level}
J_PYRAMIDS = {"K6": j_pallas_lookup.pallas_lookup_pyramid,
              "K7": j_pallas_lookup.pallas_lookup_pyramid_grouped}
# (H/8, W/8, levels): N = 35 and 285 are multiples of neither 32 nor 8; the
# coarsest levels are 1 x 1 and 1 x 2
SHAPES = {"5x7": (5, 7, 3), "15x19": (15, 19, 4)}
B = 3


def _volumes(h8, w8, levels, dtype, seed=0):
    """Random (B, N, H8 >> l, W8 >> l) volumes as f32 numpy arrays holding
    values that ``dtype`` represents exactly."""
    rng = np.random.default_rng(seed)
    n = h8 * w8
    return [np.array(jnp.asarray(rng.normal(size=(B, n, h8 >> l, w8 >> l)),
                                 dtype), np.float32) for l in range(levels)]


def _centres(h8, w8, seed=1):
    """(B, H8, W8, 2) centres near the identity; the first queries of each
    batch entry far off the level, huge, infinite and NaN. Returns them and
    the mask (B, N) of queries with finite centres."""
    rng = np.random.default_rng(seed)
    yg, xg = np.meshgrid(np.arange(h8, dtype=np.float32),
                         np.arange(w8, dtype=np.float32), indexing="ij")
    c = np.tile(np.stack([xg, yg], -1)[None], (B, 1, 1, 1))
    c = (c + rng.uniform(-3.0, 3.0, c.shape)).astype(np.float32)
    flat = c.reshape(B, -1, 2)
    flat[:, 0] = (-60.0, 40.5)
    flat[:, 1] = (7.25, 1e4)
    flat[:, 2] = 1e30
    flat[:, 3] = np.nan
    flat[:, 4, 0] = np.nan
    flat[:, 5, 1] = -np.inf
    return c, np.isfinite(flat).all(-1)


def _torch_inputs(vols, dtype):
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return [torch.from_numpy(v).to(tdt) for v in vols]


@pytest.mark.parametrize("kernel", ["K6", "K7"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_pyramid_matches_pallas_at_ragged_shapes(kernel, dtype, shape):
    """The pyramid wrappers (the plain version on the CPU) against
    ``pallas_lookup_pyramid`` (K6) / ``_grouped`` (K7) in interpret mode at
    every level, B = 3: atol 1e-5 + rtol 1e-5 (the same f32 products; the
    Pallas sums run as dot products over the whole level, whose two live
    terms may be fused into one rounding). Queries with a NaN or infinite
    centre are left out of that comparison (the Pallas kernels turn them
    into integers first, and the grouped one's block-diagonal product
    spreads a NaN over the 8 queries of its group, which are left out with
    it): everywhere the pyramid entry must give what the level entry gives,
    bit for bit."""
    h8, w8, levels = SHAPES[shape]
    n = h8 * w8
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    vols = _volumes(h8, w8, levels, jdt)
    coords, finite = _centres(h8, w8)
    if kernel == "K7":
        group = np.arange(B * n) // j_pallas_lookup.GROUP
        bad = np.unique(group[~finite.reshape(-1)])
        finite = ~np.isin(group, bad).reshape(B, n)
    ref = J_PYRAMIDS[kernel]([jnp.asarray(v, jdt) for v in vols],
                             jnp.asarray(coords), interpret=True)
    pyr = _torch_inputs(vols, dtype)
    got = PYRAMIDS[kernel](pyr, torch.from_numpy(coords))
    assert len(got) == levels
    for lvl, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == (B, 81, n) and g.dtype == torch.float32
        r = np.asarray(r).reshape(B, n, 81)
        np.testing.assert_allclose(g.numpy().transpose(0, 2, 1)[finite], r[finite],
                                   rtol=1e-5, atol=1e-5, err_msg=f"level {lvl}")
        one = LEVELS[kernel](pyr[lvl].reshape(B * n, *pyr[lvl].shape[2:]),
                             torch.from_numpy(coords.reshape(B * n, 2) / 2 ** lvl))
        np.testing.assert_array_equal(
            g.numpy().transpose(0, 2, 1).reshape(B * n, 81), one.numpy())
    # far-off and huge centres read nothing
    assert all(bool((g[:, :, :3] == 0).all()) for g in got)
    assert any(bool((g[:, :, 6:] != 0).any()) for g in got)


@pytest.mark.parametrize("kernel", ["K6", "K7"])
@pytest.mark.parametrize("batch", [1, 3])
def test_pyramid_returns_views_of_one_buffer(kernel, batch):
    """The levels come back as L views (B, 81, N), f32, of one
    (B, L*81, N) buffer, level l at channels 81 l .. 81 l + 80, and
    ``SplitConv1x1`` gives the same result from the views as from
    contiguous copies of them (atol 0: the same products)."""
    h8, w8, levels = 6, 10, 3
    n = h8 * w8
    rng = np.random.default_rng(3)
    pyr = [torch.from_numpy(rng.normal(size=(batch, n, h8 >> l, w8 >> l))
                            .astype(np.float32)) for l in range(levels)]
    coords = torch.from_numpy(rng.uniform(0, 8, (batch, h8, w8, 2)).astype(np.float32))
    got = PYRAMIDS[kernel](pyr, coords)
    assert isinstance(got, list) and len(got) == levels
    storage = got[0].untyped_storage()
    assert storage.nbytes() == batch * levels * 81 * n * 4
    for lvl, g in enumerate(got):
        assert g.shape == (batch, 81, n) and g.dtype == torch.float32
        assert g.untyped_storage().data_ptr() == storage.data_ptr()
        assert g.storage_offset() == lvl * 81 * n
        assert g.stride() == (levels * 81 * n, n, 1)
    conv = SplitConv1x1(levels * 81, 16)
    with torch.no_grad():
        from_views = conv(got, (h8, w8))
        from_copies = conv([g.clone(memory_format=torch.contiguous_format)
                            for g in got], (h8, w8))
    assert torch.equal(from_views, from_copies)


def _good(dtype=torch.float32):
    """A 2-level pyramid and its centres that the wrappers take."""
    pyr = [torch.zeros(2, 12, 6, 9, dtype=dtype), torch.zeros(2, 12, 3, 4, dtype=dtype)]
    return pyr, torch.zeros(2, 3, 4, 2)


def _mixed_dtypes():
    pyr, coords = _good()
    return [pyr[0], pyr[1].bfloat16()], coords, TypeError, "level 1 is torch.bfloat16"


def _mixed_devices():
    pyr, coords = _good()
    return [pyr[0], pyr[1].to("meta")], coords, ValueError, "level 1 on meta"


def _coords_elsewhere():
    pyr, coords = _good()
    return pyr, coords.to("meta"), ValueError, "coords on meta"


def _non_contiguous():
    pyr, coords = _good()
    wide = torch.zeros(2, 12, 3, 8)
    return [pyr[0], wide[..., ::2]], coords, ValueError, "level 1 is not contiguous"


def _not_pooled():
    pyr, coords = _good()
    return [pyr[0], torch.zeros(2, 12, 3, 5)], coords, ValueError, "pooled by 2"


def _other_queries():
    pyr, coords = _good()
    return [pyr[0], torch.zeros(2, 11, 3, 4)], coords, ValueError, "level 1 is"


def _bad_dtype():
    pyr, coords = _good(torch.float16)
    return pyr, coords, TypeError, "float16"


def _too_many_levels():
    pyr, coords = _good()
    pyr = [torch.zeros(2, 12, 16 >> l, 16 >> l) for l in range(5)]
    return pyr, coords, ValueError, "5 levels"


def _bad_coords():
    pyr, _ = _good()
    return pyr, torch.zeros(2, 3, 4, 3), ValueError, r"\(B, H, W, 2\)"


@pytest.mark.parametrize("kernel", ["K6", "K7"])
@pytest.mark.parametrize("case", [
    _mixed_dtypes, _mixed_devices, _coords_elsewhere, _non_contiguous,
    _not_pooled, _other_queries, _bad_dtype, _too_many_levels, _bad_coords],
    ids=lambda f: f.__name__.lstrip("_"))
def test_pyramid_refuses_by_name(kernel, case):
    """Mixed dtypes or devices across levels, a non-contiguous level, level
    shapes that are not the pooled halves of level 0, and the like: one
    error, which names the wrapper and the level at fault."""
    pyr, coords, exc, what = case()
    name = PYRAMIDS[kernel].__name__
    with pytest.raises(exc, match=f"{name}: .*{what}"):
        PYRAMIDS[kernel](pyr, coords)
    good, good_coords = _good()
    assert len(PYRAMIDS[kernel](good, good_coords)) == 2


@pytest.mark.parametrize("kernel", ["K6", "K7"])
def test_level_refuses_by_name(kernel):
    """The level entries (the one-level case of the same kernels) check the
    same way."""
    fn = LEVELS[kernel]
    vol, coords = torch.zeros(6, 4, 5), torch.zeros(6, 2)
    assert fn(vol, coords).shape == (6, 81)
    with pytest.raises(ValueError, match=f"{fn.__name__}: coords"):
        fn(vol, torch.zeros(5, 2))
    with pytest.raises(ValueError, match=f"{fn.__name__}: .*float32"):
        fn(vol, coords.double())
    with pytest.raises(ValueError, match=f"{fn.__name__}: .*not contiguous"):
        fn(torch.zeros(6, 4, 10)[..., ::2], coords)
    with pytest.raises(ValueError, match=f"{fn.__name__}: .*expected"):
        fn(torch.zeros(6, 20), coords)
