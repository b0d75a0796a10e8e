"""The one-launch pyramid entry of the port's on-the-fly correlation lookup
(``onthefly_lookup_pyramid``: K1 forward, one ``autograd.Function`` over
the pyramid) on the CPU, where the wrapper takes the plain version: it
matches the JAX package's Pallas kernel (interpret mode) level by level,
the levels come back as views of one buffer, the wrapper refuses by name
what the kernel does not take, the backward sums dcoords over the levels
in level order and passes through ``torch.utils.checkpoint`` unchanged;
and RAFT's ``lookup: "auto"`` takes the ``"xla"`` route on the CPU, as the
JAX package does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from robust_pose_tpu.models.raft import RAFT as JRAFT
from robust_pose_tpu.ops.pallas_corr_onthefly import (
    onthefly_lookup as j_onthefly_lookup,
    pool_fmap_pyramid as j_pool,
)
from robust_pose_tpu_torch.models.raft import RAFT
from robust_pose_tpu_torch.ops import corr_onthefly as K1
from tests.test_torch_port_common import jax_variables, random_state_dict

C = 8


def _grid(b, h8, w8):
    yg, xg = np.meshgrid(np.arange(h8, dtype=np.float32),
                         np.arange(w8, dtype=np.float32), indexing="ij")
    return np.tile(np.stack([xg, yg], -1)[None], (b, 1, 1, 1))


NONFINITE = [0, 1, 2, 4, 5]          # queries of the "nan_huge" case


def _case(case, rng):
    """(f1, f2, coords) as f32 numpy arrays: ``shifted`` by a fraction,
    ``out_of_bounds`` (most windows wholly or partly off), ``ragged``
    (N = 10 x 9 = 90, no multiple of the kernel's tiles) and ``nan_huge``
    (NaN, infinite and huge centres among near-identity ones)."""
    b, h8, w8 = (1, 10, 9) if case == "ragged" else (2, 8, 12)
    f1, f2 = (rng.normal(size=(b, h8, w8, C)).astype(np.float32) for _ in range(2))
    base = _grid(b, h8, w8)
    if case == "shifted":
        coords = base + np.float32([3.3, -2.7])
    elif case == "out_of_bounds":
        coords = base * 3.0 - 30.0
    elif case == "ragged":
        coords = base + rng.normal(0, 1.5, base.shape)
    else:
        coords = base + rng.normal(0, 1.5, base.shape)
        flat = coords.reshape(b, -1, 2)
        flat[:, 0] = np.nan
        flat[:, 1, 0] = np.nan
        flat[:, 2, 1] = np.nan
        flat[:, 3] = 1e30
        flat[:, 4] = -np.inf
        flat[:, 5, 0] = np.inf
        flat[:, 6] = (3e9, -3e9)
        flat[:, 7] = (-1e30, 5.0)
    return f1, f2, coords.astype(np.float32)


@pytest.mark.parametrize("case", ["shifted", "out_of_bounds", "ragged", "nan_huge"])
def test_pyramid_entry_matches_jax(case):
    """All 4 levels against the Pallas kernel in interpret mode, f32, atol
    1e-5 (both sum 8-channel f32 dot products, in other orders). A centre
    that is NaN or infinite gives NaN at all 81 window values of every
    level (its NaN bilinear weights multiply every tap, as in the plain
    version): the JAX kernel's NaNs lie among those (it converts the NaN
    floor to int32 first, so which taps it reaches depends on that
    conversion), and every other value agrees."""
    rng = np.random.default_rng(0)
    f1, f2, coords = _case(case, rng)
    b, h8, w8, _ = f1.shape
    ref = j_onthefly_lookup(jnp.asarray(f1), j_pool(jnp.asarray(f2)),
                            jnp.asarray(coords), interpret=True)
    before = K1.launches
    got = K1.onthefly_lookup_pyramid(
        torch.from_numpy(f1), K1.pool_fmap_pyramid(torch.from_numpy(f2)),
        torch.from_numpy(coords))
    assert K1.launches == before and len(got) == 4
    nan_q = np.zeros(h8 * w8, bool)
    if case == "nan_huge":
        nan_q[NONFINITE] = True
    for lvl, (g, r) in enumerate(zip(got, ref)):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == (b, 81, h8 * w8) and g.dtype == np.float32
        np.testing.assert_array_equal(np.isnan(g),
                                      np.broadcast_to(nan_q[None, None], g.shape))
        assert not (np.isnan(r) & ~np.isnan(g)).any()
        np.testing.assert_allclose(g[..., ~nan_q], r[..., ~nan_q], rtol=0,
                                   atol=1e-5, err_msg=f"level {lvl}")


def test_pyramid_entry_bf16_matches_jax():
    """bf16 features (f2 pooled in f32, then cast, as RAFT does) against the
    JAX kernel on the same bf16 values: both widen to f32 before any
    product, so only the order of the f32 sums differs; atol 1e-5."""
    rng = np.random.default_rng(1)
    f1, f2, coords = _case("shifted", rng)
    levels = [l.astype(jnp.bfloat16) for l in j_pool(jnp.asarray(f2))]
    f1j = jnp.asarray(f1).astype(jnp.bfloat16)
    ref = j_onthefly_lookup(f1j, levels, jnp.asarray(coords), interpret=True)
    got = K1.onthefly_lookup_pyramid(
        torch.from_numpy(np.array(f1j.astype(jnp.float32))).bfloat16(),
        [torch.from_numpy(np.array(l.astype(jnp.float32))).bfloat16()
         for l in levels], torch.from_numpy(coords))
    for lvl, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-5,
                                   err_msg=f"level {lvl}")


def _torch_case(rng, levels=4, dtype=torch.float32):
    f1, f2, coords = _case("ragged", rng)
    f1t = torch.from_numpy(f1).to(dtype)
    pyr = [v.to(dtype) for v in K1.pool_fmap_pyramid(torch.from_numpy(f2),
                                                      levels)]
    return f1t, pyr, torch.from_numpy(coords)


def test_levels_are_views_of_one_buffer():
    """Level l is ``corr_lookup_level_plain`` at scale 2^l bit for bit, a
    (B, 81, N) view at rows 81 l of one (B, L*81, N) buffer; the one-level
    entry is the plain level bit for bit."""
    f1, pyr, coords = _torch_case(np.random.default_rng(2), levels=3)
    b, h8, w8, _ = f1.shape
    n = h8 * w8
    got = K1.onthefly_lookup_pyramid(f1, pyr, coords)
    storage = got[0].untyped_storage()
    assert storage.nbytes() == b * 3 * 81 * n * 4
    f1f, cs = f1.reshape(b, n, C), coords.reshape(b, n, 2)
    for lvl, g in enumerate(got):
        assert g.shape == (b, 81, n) and g.storage_offset() == lvl * 81 * n
        assert g.untyped_storage().data_ptr() == storage.data_ptr()
        ref = K1.corr_lookup_level_plain(f1f, pyr[lvl], cs, 4, 2.0 ** lvl)
        assert torch.equal(g, ref)
        assert torch.equal(K1.corr_lookup_level(f1f, pyr[lvl], cs, 4, 2.0 ** lvl), ref)


def _refusal(kind):
    f1, pyr, coords = _torch_case(np.random.default_rng(3))
    if kind == "not_pooled":
        pyr[2] = pyr[2][:, :, :-1].contiguous()
    elif kind == "level_dtype":
        pyr[1] = pyr[1].bfloat16()
    elif kind == "f1_dtype":
        f1 = f1.bfloat16()
    elif kind == "f1_int":
        f1 = f1.int()
        pyr = [v.int() for v in pyr]
    elif kind == "five_levels":
        pyr = pyr + [pyr[-1][:, :0, :0]]
    elif kind == "channels":
        pyr[0] = torch.cat([pyr[0], pyr[0]], dim=-1)
    elif kind == "coords":
        coords = coords[:, :-1]
    return f1, pyr, coords


@pytest.mark.parametrize("kind,error,words", [
    ("not_pooled", ValueError, "level 2 is"),
    ("level_dtype", TypeError, "level 1 is torch.bfloat16"),
    ("f1_dtype", TypeError, "level 0 is torch.float32"),
    ("f1_int", TypeError, "float32 or bfloat16"),
    ("five_levels", ValueError, "5 levels"),
    ("channels", ValueError, "level 0 is"),
    ("coords", ValueError, "expected (B, H, W, C) and (B, H, W, 2)"),
])
def test_wrapper_refuses(kind, error, words):
    """Levels that are not pooled halves of level 0, dtypes that differ or
    that the kernel does not take, more than 4 levels, other channel
    counts and centres of another grid raise, naming what is wrong, on CPU
    tensors as on the card."""
    f1, pyr, coords = _refusal(kind)
    with pytest.raises(error, match=words.replace("(", r"\(").replace(")", r"\)")):
        K1.onthefly_lookup_pyramid(f1, pyr, coords)


def _grads(f1, pyr, coords, gs, remat=False):
    leaves = [t.clone().requires_grad_() for t in (f1, coords, *pyr)]

    def run(a, c, *ls):
        return K1.onthefly_lookup_pyramid(a, list(ls), c)

    outs = checkpoint(run, *leaves, use_reentrant=False) if remat else run(*leaves)
    torch.autograd.backward(outs, gs)
    return [t.grad for t in leaves]


def test_backward_sums_the_levels_in_order():
    """The pyramid ``Function``'s cotangents: dcoords is the per-level
    plain version's dcoords summed in level order, df1 likewise, dlevel l
    the plain version's; bit for bit, and the same through
    ``torch.utils.checkpoint``."""
    rng = np.random.default_rng(4)
    f1, pyr, coords = _torch_case(rng)
    b, h8, w8, _ = f1.shape
    n = h8 * w8
    gs = [torch.from_numpy(rng.normal(size=(b, 81, n)).astype(np.float32))
          for _ in pyr]
    got = _grads(f1, pyr, coords, gs)
    df1 = dco = None
    for lvl, (v, g) in enumerate(zip(pyr, gs)):
        a = f1.reshape(b, n, C).clone().requires_grad_()
        vv = v.clone().requires_grad_()
        c = coords.reshape(b, n, 2).clone().requires_grad_()
        out = K1.corr_lookup_level_plain(a, vv, c, 4, 2.0 ** lvl)
        d1, dv, dc = torch.autograd.grad(out, (a, vv, c), g)
        df1 = d1 if df1 is None else df1 + d1
        dco = dc if dco is None else dco + dc
        assert torch.equal(got[2 + lvl], dv)
    assert torch.equal(got[0], df1.reshape(f1.shape))
    assert torch.equal(got[1], dco.reshape(coords.shape))
    again = _grads(f1, pyr, coords, gs, remat=True)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_auto_lookup_takes_xla_on_the_cpu(monkeypatch):
    """RAFT with the default ``lookup: "auto"`` on CPU features runs the
    ``"xla"`` route (K1's plain version and wrapper are never called), as
    the JAX package's RAFT does on its CPU backend, and matches it: flow
    atol 1e-3 px, hidden state atol 1e-4 (f32, iters 2, 64 x 96)."""
    def refuse(*a, **k):
        raise AssertionError("K1 called on the CPU under lookup 'auto'")

    monkeypatch.setattr(K1, "corr_lookup_level_plain", refuse)
    monkeypatch.setattr(K1, "pyramid_forward", refuse)
    port = RAFT(iters=2, dtype=torch.float32, corr_dtype=torch.float32).eval()
    assert port.lookup == "auto"
    sd = random_state_dict(port, seed=3)
    port.load_state_dict(sd)
    jmodel = JRAFT(iters=2, dtype=jnp.float32, corr_dtype=jnp.float32)
    rng = np.random.default_rng(5)
    f1, f2 = (rng.normal(size=(1, 8, 12, 256)).astype(np.float32) for _ in range(2))
    net = np.tanh(rng.normal(size=(1, 8, 12, 128))).astype(np.float32)
    inp = np.maximum(rng.normal(size=(1, 8, 12, 128)), 0).astype(np.float32)
    args = [f1, f2, net, inp]
    with jax.default_matmul_precision("float32"):
        ref = jmodel.apply(jax_variables(sd), *map(jnp.asarray, args),
                           method=JRAFT.flow_from_features)
    with torch.no_grad():
        got = port.flow_from_features(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-3)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-4)
