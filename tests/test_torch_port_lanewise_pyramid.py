"""The one-launch pyramid entry of the port's lane-wise lookup
(``lanewise_lookup``: K4 forward, K5 backward, one ``autograd.Function``
over the pyramid) on the CPU, where the wrappers take the plain versions:
forward and backward equal the per-level plain versions bit for bit, the
levels come back as views of one buffer, the results match the JAX
package's Pallas kernels (interpret mode) and their custom VJP, the
wrapper refuses by name what the kernels do not take, and the gradients
pass through ``torch.utils.checkpoint`` unchanged."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from robust_pose_tpu.ops.pallas_lookup_lanewise import (
    build_corr_pyramid_t as j_build_t,
    lanewise_lookup as j_lanewise_lookup,
)
from robust_pose_tpu_torch.models.raft import SplitConv1x1
from robust_pose_tpu_torch.ops import corr_lanewise as L

B = 2


def _coords(h8, w8, rng, special=True):
    """(B, H8, W8, 2) centres near the identity; with ``special`` a few
    queries partly or wholly off the level."""
    yg, xg = np.meshgrid(np.arange(h8, dtype=np.float32),
                         np.arange(w8, dtype=np.float32), indexing="ij")
    c = np.tile(np.stack([xg, yg], -1)[None], (B, 1, 1, 1))
    c = c + rng.normal(0, 2.0, c.shape)
    if special:
        flat = c.reshape(B, -1, 2)
        flat[:, ::7] = flat[:, ::7] * 3.0 - 30.0
        flat[:, 3] = (-60.0, 40.5)
    return c.astype(np.float32)


def _pyramid(h8, w8, dtype, rng, levels=4):
    """The transposed pyramid of random features, built by the JAX package,
    as f32 numpy arrays holding values that ``dtype`` represents exactly."""
    f1, f2 = (rng.normal(size=(B, h8, w8, 8)).astype(np.float32) for _ in range(2))
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    pj = j_build_t(jnp.asarray(f1), jnp.asarray(f2), num_levels=levels, dtype=jdt)
    return pj, [np.array(p.astype(jnp.float32)) for p in pj]


def _torch_pyramid(vols, dtype, grad=False):
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return [torch.from_numpy(v).to(tdt).requires_grad_(grad) for v in vols]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pyramid_entry_equals_the_plain_levels(dtype):
    """``lanewise_lookup`` on CPU tensors: level l of the forward is
    ``lanewise_fwd_plain`` at scale 2^l bit for bit, the levels are views of
    one (B, L*81, N) buffer that ``SplitConv1x1`` takes as they are; the
    backward gives ``lanewise_bwd_plain``'s dcorr for every level and the sum
    of its dcoords in level order, bit for bit; neither launch counter
    moves."""
    rng = np.random.default_rng(1)
    h8, w8, levels = 9, 11, 4
    n = h8 * w8
    _, vols = _pyramid(h8, w8, dtype, rng, levels)
    coords = torch.from_numpy(_coords(h8, w8, rng))
    gs = [torch.from_numpy(rng.normal(size=(B, 81, n)).astype(np.float32))
          for _ in range(levels)]
    before = (L.launches, L.bwd_launches)
    pyr = _torch_pyramid(vols, dtype, grad=True)
    c = coords.clone().requires_grad_()
    got = L.lanewise_lookup(pyr, c)
    assert isinstance(got, list) and len(got) == levels
    storage = got[0].untyped_storage()
    assert storage.nbytes() == B * levels * 81 * n * 4
    flat = coords.reshape(B, n, 2)
    for lvl, g in enumerate(got):
        assert g.shape == (B, 81, n) and g.dtype == torch.float32
        assert g.untyped_storage().data_ptr() == storage.data_ptr()
        assert g.storage_offset() == lvl * 81 * n
        assert torch.equal(g.detach(), L.lanewise_fwd_plain(
            pyr[lvl].detach(), flat, 4, float(2 ** lvl)))
    conv = SplitConv1x1(levels * 81, 8)
    with torch.no_grad():
        assert torch.equal(conv([g.detach() for g in got], (h8, w8)),
                           conv([g.detach().clone() for g in got], (h8, w8)))
    grads = torch.autograd.grad(got, pyr + [c], gs)
    ref_dc = None
    for lvl in range(levels):
        dcorr, dco = L.lanewise_bwd_plain(pyr[lvl].detach(), flat, gs[lvl], 4,
                                          float(2 ** lvl))
        assert grads[lvl].dtype == pyr[lvl].dtype
        assert torch.equal(grads[lvl], dcorr), f"dcorr, level {lvl}"
        ref_dc = dco if ref_dc is None else ref_dc + dco
    assert torch.equal(grads[-1], ref_dc.reshape(B, h8, w8, 2))
    assert (L.launches, L.bwd_launches) == before


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", ["12x16", "9x11"])
def test_pyramid_entry_matches_pallas(shape, dtype):
    """The same pyramid and centres through the JAX package's
    ``lanewise_lookup`` (Pallas kernels in interpret mode) with ``jax.vjp``,
    and through the port's pyramid entry with ``torch.autograd.grad``, all 4
    levels; N = 192 and N = 99 (no multiple of the kernels' 64 queries a
    block, nor of the Pallas kernel's 128 lanes). Forward atol 1e-5 (the same
    f32 products, summed in other orders); dcorr atol 1e-5, and rtol 2^-7
    with a bf16 volume (rounded to bf16 once on each side); dcoords, summed
    over the levels, atol 1e-5 of its largest."""
    h8, w8 = (12, 16) if shape == "12x16" else (9, 11)
    n = h8 * w8
    rng = np.random.default_rng(h8 + (dtype == "bf16"))
    pj, vols = _pyramid(h8, w8, dtype, rng)
    coords = _coords(h8, w8, rng)
    gs = [rng.normal(size=(B, 81, n)).astype(np.float32) for _ in pj]

    def run(pyr, cc, cts):
        out, vjp = jax.vjp(lambda p, c: j_lanewise_lookup(p, c, interpret=True),
                           pyr, cc)
        return out, vjp(cts)

    out_j, (dpyr_j, dco_j) = jax.jit(run)(
        pj, jnp.asarray(coords), [jnp.asarray(g) for g in gs])
    pyr = _torch_pyramid(vols, dtype, grad=True)
    c = torch.from_numpy(coords).requires_grad_()
    got = L.lanewise_lookup(pyr, c)
    grads = torch.autograd.grad(got, pyr + [c], [torch.from_numpy(g) for g in gs])
    for lvl in range(len(pyr)):
        np.testing.assert_allclose(got[lvl].detach().numpy(), np.asarray(out_j[lvl]),
                                   atol=1e-5, err_msg=f"forward, level {lvl}")
        np.testing.assert_allclose(
            grads[lvl].float().numpy(), np.asarray(dpyr_j[lvl].astype(jnp.float32)),
            rtol=2 ** -7 if dtype == "bf16" else 0, atol=1e-5,
            err_msg=f"dcorr, level {lvl}")
    ref = np.asarray(dco_j)
    np.testing.assert_allclose(grads[-1].numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max(), err_msg="dcoords")


def _good(dtype=torch.float32):
    """A 2-level pyramid (B = 2, 6 x 8, N = 12) and centres (B, 3, 4, 2)
    that the wrapper takes."""
    pyr = [torch.zeros(2, 6, 8, 12, dtype=dtype), torch.zeros(2, 3, 4, 12, dtype=dtype)]
    return pyr, torch.zeros(2, 3, 4, 2)


def _not_pooled():
    pyr, coords = _good()
    return [pyr[0], torch.zeros(2, 3, 5, 12)], coords, ValueError, "level 1 is .*pooled by 2"


def _mixed_dtypes():
    pyr, coords = _good()
    return [pyr[0], pyr[1].bfloat16()], coords, TypeError, "level 1 is torch.bfloat16"


def _mixed_devices():
    pyr, coords = _good()
    return [pyr[0], pyr[1].to("meta")], coords, ValueError, "level 1 on meta"


def _non_contiguous():
    pyr, coords = _good()
    wide = torch.zeros(2, 3, 4, 24)
    return [pyr[0], wide[..., ::2]], coords, ValueError, "level 1 is not contiguous"


def _other_queries():
    pyr, coords = _good()
    return [pyr[0], torch.zeros(2, 3, 4, 11)], coords, ValueError, "level 1 is"


def _bad_volume_dtype():
    pyr, coords = _good(torch.float16)
    return pyr, coords, TypeError, "volume dtype torch.float16"


def _too_many_levels():
    _, coords = _good()
    pyr = [torch.zeros(2, 16 >> l, 16 >> l, 12) for l in range(5)]
    return pyr, coords, ValueError, "5 levels"


def _coords_last_dim():
    pyr, _ = _good()
    return pyr, torch.zeros(2, 3, 4, 3), ValueError, r"coords \(2, 3, 4, 3\)"


def _coords_other_grid():
    pyr, _ = _good()
    return pyr, torch.zeros(2, 3, 5, 2), ValueError, r"coords \(2, 15, 2\)"


def _coords_dtype():
    pyr, coords = _good()
    return pyr, coords.double(), TypeError, "coords torch.float64"


def _coords_elsewhere():
    pyr, coords = _good()
    return pyr, coords.to("meta"), ValueError, "coords on meta"


@pytest.mark.parametrize("case", [
    _not_pooled, _mixed_dtypes, _mixed_devices, _non_contiguous, _other_queries,
    _bad_volume_dtype, _too_many_levels, _coords_last_dim, _coords_other_grid,
    _coords_dtype, _coords_elsewhere], ids=lambda f: f.__name__.lstrip("_"))
def test_pyramid_entry_refuses_by_name(case):
    """Levels that are not the pooled halves of level 0, mixed dtypes or
    devices, a non-contiguous level, centres of the wrong shape or dtype: one
    error each, which names the wrapper and the argument at fault; the good
    inputs beside them pass."""
    pyr, coords, exc, what = case()
    with pytest.raises(exc, match=f"lanewise_lookup: .*{what}"):
        L.lanewise_lookup(pyr, coords)
    good, good_coords = _good()
    out = L.lanewise_lookup(good, good_coords)
    assert len(out) == 2 and out[0].shape == (2, 81, 12)


def test_pyramid_entry_takes_expanded_centres():
    """RAFT's first GRU iteration passes the pixel grid expanded over the
    batch (stride 0): the entry makes it contiguous instead of refusing."""
    pyr, _ = _good()
    grid = torch.zeros(1, 3, 4, 2).expand(2, 3, 4, 2)
    assert not grid.is_contiguous()
    assert len(L.lanewise_lookup(pyr, grid)) == 2


def test_level_entries_are_the_one_level_case():
    """``lanewise_fwd`` / ``lanewise_bwd`` (one level, any scale) give what
    the pyramid functions give for a one-level pyramid, bit for bit, and
    refuse a cotangent of the wrong shape by name."""
    rng = np.random.default_rng(5)
    vol = torch.from_numpy(rng.normal(size=(B, 5, 7, 30)).astype(np.float32))
    coords = torch.from_numpy(rng.uniform(-3, 12, (B, 30, 2)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(B, 81, 30)).astype(np.float32))
    out = L.lanewise_fwd(vol, coords, 4, 2.0)
    assert torch.equal(out, L.lanewise_fwd_pyramid([vol], coords, 4, 2.0))
    assert torch.equal(out, L.lanewise_fwd_plain(vol, coords, 4, 2.0))
    dcorr, dco = L.lanewise_bwd(vol, coords, g, 4, 2.0)
    dcorrs, dco_p = L.lanewise_bwd_pyramid([vol], coords, g, 4, 2.0)
    assert torch.equal(dcorr, dcorrs[0]) and torch.equal(dco, dco_p)
    with pytest.raises(ValueError, match=r"lanewise_bwd: cotangent \(2, 80, 30\)"):
        L.lanewise_bwd(vol, coords, g[:, :80].contiguous(), 4, 2.0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gradients_pass_through_checkpoint(dtype):
    """Under ``torch.utils.checkpoint`` (RAFT's remat: the lookup runs again
    in the backward pass, the pyramid a closure variable as in
    ``RAFT.flow_from_features``) the gradients of the volumes and of the
    centres equal those without it, bit for bit."""
    rng = np.random.default_rng(6)
    h8, w8, levels = 6, 8, 3
    _, vols = _pyramid(h8, w8, dtype, rng, levels)
    coords = _coords(h8, w8, rng, special=False)
    weight = torch.from_numpy(rng.normal(size=(levels, 81, 1)).astype(np.float32))

    def grads(remat):
        pyr = _torch_pyramid(vols, dtype, grad=True)
        c = torch.from_numpy(coords).requires_grad_()

        def step(cc):
            outs = L.lanewise_lookup(pyr, cc)
            delta = sum((o * weight[l]).sum(1) for l, o in enumerate(outs))
            return cc + 0.01 * delta.reshape(B, h8, w8, 1)

        c1 = c
        for _ in range(2):
            c1 = checkpoint(step, c1, use_reentrant=False) if remat else step(c1)
        (c1 ** 2).sum().backward()
        return [p.grad for p in pyr] + [c.grad]

    for a, b in zip(grads(False), grads(True)):
        assert a is not None and torch.equal(a, b)
        assert float(a.float().abs().max()) > 0
