"""The port's row gathers and the surfel-winner probes on the CPU.

``ops/gather.py``: ``gather_rows`` / ``gather_rows_batched`` against the
JAX functions on the same numpy inputs, bit for bit, whole and chunked, in
value and gradient. The probes (``scripts/profile_{winner_prims,scatter,
warp4,render_decomp,device}.py``): their building blocks at 16x24 with a
2-frame pool against the JAX compositions the JAX scripts time (the JAX
surfel map's ``_seg_kmax`` / ``_seg_covered``, ``.at[].max(mode="drop")``,
``.at[].set(unique_indices=True)``, ``lax.sort``, ``project2image``):
integers and booleans bit for bit, f32 within 1e-6 relative. Each script
parses the JAX script's flags and refuses the CPU for timing.
"""
import importlib
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_pose_tpu import se3 as jse3
from robust_pose_tpu.ops import gather as jgather
from robust_pose_tpu.ops.geometry import project2image as jproject2image
from robust_pose_tpu.slam import surfel_map as jsm
from robust_pose_tpu_torch.ops import gather as pgather
from robust_pose_tpu_torch.scripts import profile_device as pdev
from robust_pose_tpu_torch.scripts import profile_render_decomp as prd
from robust_pose_tpu_torch.scripts import profile_scatter as psc
from robust_pose_tpu_torch.scripts import profile_warp4 as pw4
from robust_pose_tpu_torch.scripts import profile_winner_prims as pwp
from robust_pose_tpu_torch.slam import surfel_map as psm
from robust_pose_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
H, W, FRAMES = 16, 24, 2
N = H * W
ALLOC = FRAMES * N + N
CPU = torch.device("cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _np(t):
    return t.numpy()


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jmax(n, init, pix, vals):
    """The JAX scripts' ``jnp.full(n, init).at[pix].max(vals, mode="drop")``."""
    return jnp.full((n,), init, jnp.asarray(vals).dtype).at[pix].max(
        vals, mode="drop")


def _jsort_winner(pix, key, n):
    """The JAX scripts' sort + tail-set winner."""
    ps, ks = jax.lax.sort((pix, key), num_keys=2)
    is_last = jnp.concatenate([ps[1:] != ps[:-1], jnp.ones((1,), bool)])
    idx = jnp.where(is_last, ps, n)
    return jnp.full((n,), -1, jnp.int32).at[idx].set(
        ks, mode="drop", unique_indices=True)


def _eq(got, ref):
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


# ---------------------------------------------------------------------------
# ops/gather.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 16, 64, 1000])
@pytest.mark.parametrize("n", [7, 64, 100, 129])
def test_gather_rows_matches_jax(n, chunk):
    rng = np.random.default_rng(n)
    flat = rng.standard_normal((50, 5)).astype(np.float32)
    idx = rng.integers(0, 50, n).astype(np.int32)
    ref = jgather.gather_rows(jnp.asarray(flat), jnp.asarray(idx),
                              **({} if chunk is None else {"chunk": chunk}))
    got = pgather.gather_rows(torch.from_numpy(flat), torch.from_numpy(idx), chunk)
    _eq(got, ref)
    np.testing.assert_array_equal(_np(got), flat[idx])


def test_gather_rows_1d_squeeze_matches_jax():
    rng = np.random.default_rng(2)
    flat = np.arange(40.0, dtype=np.float32)
    idx = rng.integers(0, 40, 90).astype(np.int32)
    ref = jgather.gather_rows(jnp.asarray(flat), jnp.asarray(idx), chunk=32)
    got = pgather.gather_rows(torch.from_numpy(flat), torch.from_numpy(idx), 32)
    assert got.shape == (90,)
    _eq(got, ref)


def test_gather_rows_batched_matches_jax():
    rng = np.random.default_rng(3)
    flat = rng.standard_normal((3, 30, 4)).astype(np.float32)
    idx = rng.integers(0, 30, (3, 70)).astype(np.int32)
    ref = jgather.gather_rows_batched(jnp.asarray(flat), jnp.asarray(idx), chunk=16)
    for chunk in (None, 16):
        _eq(pgather.gather_rows_batched(torch.from_numpy(flat),
                                        torch.from_numpy(idx), chunk), ref)


def test_gather_rows_gradient_matches_jax():
    """The gradient of an integer-weighted sum through the chunked gather
    (autograd's own backward) equals JAX's bit for bit (atol 0)."""
    rng = np.random.default_rng(5)
    flat = rng.standard_normal((25, 3)).astype(np.float32)
    idx = rng.integers(0, 25, 60).astype(np.int32)
    wts = rng.integers(-3, 4, (60, 3)).astype(np.float32)
    gref = jax.grad(lambda t: (jgather.gather_rows(t, jnp.asarray(idx), chunk=16)
                               * wts).sum())(jnp.asarray(flat))
    for chunk in (None, 16):
        t = torch.from_numpy(flat).requires_grad_(True)
        (pgather.gather_rows(t, torch.from_numpy(idx), chunk)
         * torch.from_numpy(wts)).sum().backward()
        np.testing.assert_allclose(_np(t.grad), np.asarray(gref), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the probes' primitives against the JAX compositions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def winner():
    """profile_winner_prims's inputs at a 2-frame 16x24 pool, as numpy too."""
    xs = pwp.winner_inputs(ALLOC, N, CPU, _gen(0))
    return xs, [jnp.asarray(_np(x)) for x in xs]


def test_winner_prims_match_jax(winner):
    (pix, key, mat, bp, bk), (jp, jk, jm, jbp, jbk) = winner
    assert pwp.check(pix, key, mat, bp, bk, N) == {
        "winner": True, "covered": True, "extension": True}
    ref_w = _jmax(N, -1, jp, jk)
    _eq(pwp.scatter_winner(pix, key, N), ref_w)
    _eq(psm._seg_kmax(pix, key, N), jsm._seg_kmax(jp, jk, N))
    pixc, jpc = torch.clamp(pix, max=N - 1), jnp.minimum(jp, N - 1)
    _eq(psm._seg_covered(pixc, mat, N), jsm._seg_covered(jpc, jm, N))
    _eq(pwp.scatter_covered(pixc, mat, N), _jmax(N, 0, jpc, jm) > 0)
    ref_e = ref_w.at[jbp].max(jbk, mode="drop", unique_indices=True,
                              indices_are_sorted=True)
    _eq(pwp.extend_unique(pwp.scatter_winner(pix, key, N), bp, bk, N), ref_e)
    ps, ks = psm._sort_pairs(pix, key)
    jps, jks = jax.lax.sort((jp, jk), num_keys=2)
    _eq(ps, jps)
    _eq(ks, jks)
    _eq(torch.sort((pix << 1) | mat).values, jax.lax.sort((jp << 1) | jm))


def test_scatter_probe_matches_jax():
    gen = _gen(1)
    for upd in (N, 5 * N):
        pix, key = psc.scatter_inputs(upd, N, CPU, gen)
        jp, jk = jnp.asarray(_np(pix)), jnp.asarray(_np(key))
        assert psc.check(pix, key, N) == {"2col_key_column": True,
                                          "sort_tail_set": True}
        payload = jnp.stack([jk, (jk > 0).astype(jnp.int32)], axis=-1)
        _eq(psc.winner_2col(pix, key, N),
            jnp.full((N, 2), -1, jnp.int32).at[jp].max(payload, mode="drop"))
        _eq(psc.sort_winner(pix, key, N), _jsort_winner(jp, jk, N))
        m = key % 2 > 0
        _eq(psc.covered_bool(pix, m.to(torch.uint8), N),
            jnp.zeros((N,), bool).at[jp].max(jnp.asarray(_np(m)), mode="drop"))
    # the unique set where its indices are unique: a permutation with drops
    perm = torch.randperm(N + 1, generator=gen).to(torch.int32)
    ids = torch.arange(N + 1, dtype=torch.int32)
    ref = jnp.zeros((N,), jnp.int32).at[jnp.asarray(_np(perm))].set(
        jnp.asarray(_np(ids)), mode="drop", unique_indices=True)
    _eq(psc.unique_set(perm, ids, N), ref)


def test_warp4_chunks_match_jax():
    """The chunked gathers against the JAX script's ``gather_chunked``, the
    chained scatter chunks against the JAX script's composition."""
    jw4 = _jax_script("profile_warp4")
    fuse, warp, (pix, key) = (pw4.gather_inputs(5 * N, N, 8, CPU, _gen(2)),
                              pw4.gather_inputs(N, (H + 1) * (W + 1), 16, CPU, _gen(3)),
                              psc.scatter_inputs(5 * N, N, CPU, _gen(4)))
    assert all(pw4.check(fuse, warp, (pix, key), N).values())
    for (tbl, idx), chunks in ((fuse, pw4.FUSE_CHUNKS), (warp, pw4.WARP_CHUNKS)):
        for s in chunks:
            ref = jw4.gather_chunked(jnp.asarray(_np(tbl)), jnp.asarray(_np(idx)), s)
            _eq(pgather.gather_rows(tbl, idx, pw4.chunk_rows(idx.shape[0], s)), ref)
    jp, jk = jnp.asarray(_np(pix)), jnp.asarray(_np(key))
    for s in pw4.SCATTER_CHUNKS:
        out, step = jnp.full((N,), -1, jnp.int32), jp.shape[0] // s
        for j in range(s):
            pj = jax.lax.dynamic_slice_in_dim(jp, j * step, step)
            if j:
                pj, _ = jax.lax.optimization_barrier((pj, out))
            out = out.at[pj].max(jax.lax.dynamic_slice_in_dim(jk, j * step, step),
                                 mode="drop")
        _eq(pw4.scatter_max_chunked(pix, key, N, s), out)


@pytest.fixture(scope="module")
def pool():
    """profile_render_decomp's batch at a 2-frame 16x24 pool, as numpy too."""
    b = prd.pool_batch(H, W, FRAMES, CPU, _gen(6))
    return b, {k: jnp.asarray(_np(v)) for k, v in b.items()}


def test_render_decomp_phases_match_jax(pool):
    b, j = pool
    assert all(prd.check(b, N).values())
    # 1. the projection
    kmat = prd.intrinsics(H, W, CPU)
    ipts, inb = prd.project2image(b["opts"], kmat, (H, W), psm.se3.identity(()))
    jipts, jinb = jproject2image(j["opts"][None], jnp.asarray(_np(kmat))[None],
                                 (H, W), jse3.identity(())[None])
    np.testing.assert_allclose(_np(ipts), np.asarray(jipts[0]), rtol=1e-6, atol=0)
    _eq(inb, jinb[0])
    # 2. the key pack
    slot_bits = max(int(ALLOC - 1).bit_length(), 1)
    qmax = (1 << (31 - slot_bits)) - 1
    q = jnp.clip((j["conf"] * qmax).astype(jnp.int32), 0, qmax)
    ref = jnp.where(j["pix"] < N,
                    (q << slot_bits) | jnp.arange(ALLOC, dtype=jnp.int32), -1)
    _eq(prd.pack_keys(b["conf"], b["pix"] < N), ref)
    # 5. the winner gathers
    sl = jnp.clip(j["slot_img"], 0, ALLOC - 1)
    tbl = prd.pool_table(b["opts"], b["rgb"], b["conf"])
    jtbl = jnp.concatenate([j["opts"], j["rgb"], j["conf"][:, None]], axis=-1)
    _eq(prd.winner_gather(tbl, b["slot_img"]), jgather.gather_rows(jtbl, sl))
    for got, t in zip(prd.winner_gather_split(b["opts"], b["rgb"], b["conf"],
                                              b["slot_img"]),
                      (j["opts"], j["rgb"], j["conf"])):
        _eq(got, jgather.gather_rows(t, sl))
    # 6. the output assembly
    have = j["slot_img"] >= 0
    zcam = jse3.act(jse3.identity(())[None], j["win"][:, :3])[:, 2]
    refs = (jnp.where(have[:, None], j["win"][:, 3:6], 0.0).reshape(1, H, W, 3),
            jnp.where(have, zcam, 0.0).reshape(1, H, W, 1),
            jnp.where(have, j["win"][:, 6], 0.0).reshape(1, H, W, 1))
    for got, ref in zip(prd.assemble(b["win"], b["slot_img"], H, W), refs):
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-6, atol=0)
    # 7. the pixel calc
    active = jnp.arange(ALLOC) < FRAMES * N
    ipt = j["opts"]
    px = jnp.clip(ipt[:, 0].astype(jnp.int32), 0, W - 1)
    py = jnp.clip(ipt[:, 1].astype(jnp.int32), 0, H - 1)
    ref = jnp.where((j["pix"] < N) & active, py * W + px, N)
    _eq(prd.pixel_calc(b["opts"], b["pix"] < N, torch.arange(ALLOC) < FRAMES * N,
                       H, W), ref)


def test_render_decomp_scatters_match_jax(pool):
    """8: two passes; 8b: fused; 8c': chained chunks; 8d: sort; 8e:
    ``_seg_kmax``: each against the JAX script's composition."""
    b, j = pool
    jp, jk, jm = j["pix"], j["key"], j["matched"]
    jcov, jwin = _jmax(N, 0, jp, jm), _jmax(N, -1, jp, jk)
    cov, win = prd.two_scatters(b["pix"], b["key"], b["matched"], N)
    _eq(cov, jcov)
    _eq(win, jwin)
    init = jnp.tile(jnp.array([[0, -1]], jnp.int32), (N, 1))
    fused = init.at[jp].max(jnp.stack([jm, jk], axis=-1), mode="drop")
    fcov, fwin = prd.fused_scatter(b["pix"], b["key"], b["matched"], N)
    _eq(fcov, fused[:, 0])
    _eq(fwin, fused[:, 1])
    for k in prd.CHUNKS:
        out, chunk = jnp.full((N,), -1, jnp.int32), ALLOC // k
        for i in range(k):
            out = out.at[jax.lax.dynamic_slice_in_dim(jp, i * chunk, chunk)].max(
                jax.lax.dynamic_slice_in_dim(jk, i * chunk, chunk), mode="drop")
        _eq(pw4.scatter_max_chunked(b["pix"], b["key"], N, k), out)
    _eq(psc.sort_winner(b["pix"], b["key"], N), _jsort_winner(jp, jk, N))
    _eq(psm._seg_kmax(b["pix"], b["key"], N), jsm._seg_kmax(jp, jk, N))
    _eq(pwp.scatter_winner(b["coherent"], b["key"], N), _jmax(N, -1, j["coherent"], jk))


def test_device_prims_match_jax():
    """profile_device's coverage by one int32 sort against the JAX
    script's ``covered_sort`` and its int32 scatter-max."""
    x = pdev.prims_inputs(H, W, FRAMES, CPU, _gen(7))
    pix, m = x["pix"], x["key"] > 2 ** 29
    jp, jm = jnp.asarray(_np(pix)), jnp.asarray(_np(m))
    s = jax.lax.sort((jp << 1) | jm.astype(jnp.int32))
    spix = s >> 1
    is_last = jnp.concatenate([spix[1:] != spix[:-1], jnp.ones((1,), bool)])
    ref = jnp.zeros((N,), bool).at[jnp.where(is_last, spix, N)].set(
        (s & 1) > 0, mode="drop", unique_indices=True)
    got = pdev.covered_sort(pix, m, N)
    _eq(got, ref)
    _eq(got, _jmax(N, 0, jp, jm.astype(jnp.int32)) > 0)
    _eq(torch.cumsum(m.int(), 0, dtype=torch.int32) - 1,
        jnp.cumsum(jm.astype(jnp.int32)) - 1)


def test_chain_keeps_inputs_and_never_moves():
    """The chain scalar is False whatever the output (NaN and infinities
    too), and adding it leaves an input's bits as they were."""
    for out in (torch.tensor([float("nan"), 1.0]), torch.tensor([float("inf")]),
                torch.tensor([[-3]], dtype=torch.int32), torch.tensor([True])):
        c = profiling.chain_scalar((out, None))
        assert c.dtype == torch.bool and not bool(c)
    for x in (torch.tensor([-0.5, 2.0], dtype=torch.bfloat16),
              torch.tensor([7, 8], dtype=torch.int32),
              torch.rand(2, 3, 4, 5).contiguous(memory_format=torch.channels_last)):
        before = x.clone()
        assert profiling.chain_into(x, torch.tensor(False)) is x
        assert torch.equal(x, before)


# ---------------------------------------------------------------------------
# command lines
# ---------------------------------------------------------------------------

SCRIPTS = {   # script: the JAX script's flags (winner_prims reads $ROWS)
    "profile_winner_prims": [],
    "profile_scatter": [],
    "profile_warp4": [],
    "profile_render_decomp": ["--frames", "4", "--iters", "8"],
    "profile_device": ["--stage", "all", "--k1", "4", "--k2", "20",
                       "--window", "8"],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_probe_cli_parses_and_refuses_the_cpu(name):
    mod = importlib.import_module(f"robust_pose_tpu_torch.scripts.{name}")
    argv = SCRIPTS[name]
    args = mod.build_parser().parse_args(argv)
    assert args.device is None
    for flag, value in zip(argv[::2], argv[1::2]):
        assert str(getattr(args, flag[2:])) == value
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        mod.main(argv + ["--device", "cpu"])


def test_winner_prims_rows_from_the_environment(monkeypatch):
    monkeypatch.setenv("ROWS", "12345")
    assert pwp.build_parser().parse_args([]).rows == 12345
    monkeypatch.delenv("ROWS")
    assert pwp.build_parser().parse_args([]).rows == 5 * 512 * 640


def test_profile_device_stages_are_the_jax_scripts():
    src = (ROOT / "scripts" / "profile_device.py").read_text()
    assert list(pdev.STAGES) == re.findall(r'want\("(\w+)"\)', src)
