"""The port's surfel map against the JAX package's on the CPU, from the same
state (``surfel_state_from_jax``) and frame: every pool function, the
winner primitives, and the ``SurfelMap`` wrapper. Integer and boolean
outputs (winner keys, slot images, masks, ``active``, ``t_created``,
``hi``, ``n_dropped``, ``tick``) must be bit-equal; f32 outputs within
2e-6 relative plus 1e-6 of the array's largest magnitude, about 8 ulp of it
(new points come from a 3x3 inverse and a back-projection that the two
packages may round an ulp apart)."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_pose_tpu import se3 as jse3
from robust_pose_tpu.slam import surfel_map as J
from robust_pose_tpu.slam.frame import make_frame as j_make_frame
from robust_pose_tpu_torch import se3
from robust_pose_tpu_torch.slam import surfel_map as P
from robust_pose_tpu_torch.slam.frame import make_frame
from robust_pose_tpu_torch.utils.convert import surfel_state_from_jax

H, W = 32, 40
N = H * W
K = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1.0]], np.float32)
POSE = np.asarray(jse3.exp(jnp.asarray([1.0, -0.5, 2.0, 0.02, -0.01, 0.03])))


def _frame(seed, depth=None):
    """A random frame as (JAX Frame, port Frame): colours, depth 90-130,
    10 % of the mask off, confidences in [0, 1]."""
    rng = np.random.default_rng(seed)
    img = (255 * rng.uniform(size=(1, H, W, 3))).astype(np.float32)
    dep = (90 + 40 * rng.uniform(size=(1, H, W, 1)) if depth is None
           else np.full((1, H, W, 1), depth)).astype(np.float32)
    msk = rng.uniform(size=(1, H, W, 1)) > 0.1
    conf = rng.uniform(size=(1, H, W, 1)).astype(np.float32)
    return (j_make_frame(*map(jnp.asarray, (img,)), depth=jnp.asarray(dep),
                         mask=jnp.asarray(msk), confidence=jnp.asarray(conf)),
            make_frame(torch.from_numpy(img), depth=torch.from_numpy(dep),
                       mask=torch.from_numpy(msk), confidence=torch.from_numpy(conf)))


def _base_state(cap=3 * N, seed=7):
    """A fragmented pool at ``pose``'s view: slots below hi = 1.5 N,
    80 % of them active, random confidences and creation ticks."""
    rng = np.random.default_rng(seed)
    alloc = cap + N
    pts = rng.uniform(size=(alloc, 3)).astype(np.float32)
    z = 80.0 + 60.0 * pts[:, 2]
    opts = np.stack([(pts[:, 0] - 0.5) * z * (W / 50.0),
                     (pts[:, 1] - 0.5) * z * (H / 50.0), z], -1).astype(np.float32)
    hi = int(1.5 * N)
    return J.SurfelState(
        opts=jse3.act(jnp.asarray(POSE)[None], jnp.asarray(opts)),
        rgb=jnp.asarray((255 * rng.uniform(size=(alloc, 3))).astype(np.float32)),
        conf=jnp.asarray(rng.uniform(size=alloc).astype(np.float32)),
        t_created=jnp.asarray(rng.integers(0, 3, alloc).astype(np.int32)),
        active=jnp.asarray((np.arange(alloc) < hi) & (rng.uniform(size=alloc) > 0.2)),
        tick=jnp.asarray(2, jnp.int32), pmat=jse3.identity(()),
        n_dropped=jnp.zeros((), jnp.int32), hi=jnp.asarray(hi, jnp.int32))


def _cfgs(**kw):
    return (J.SurfelConfig(img_shape=(H, W), **kw),
            P.SurfelConfig(img_shape=(H, W), **kw))


def _assert_same(j, p, what):
    """Integer/boolean arrays bit-equal, f32 within 2e-6 relative plus 1e-6
    of the largest magnitude."""
    j = np.asarray(j)
    p = p.numpy()
    assert p.shape == j.shape and p.dtype == j.dtype, (what, p.dtype, j.dtype)
    if j.dtype.kind in "biu":
        np.testing.assert_array_equal(p, j, err_msg=what)
    else:
        scale = float(np.abs(j).max()) if j.size else 0.0
        np.testing.assert_allclose(p, j, rtol=2e-6, atol=1e-6 * scale, err_msg=what)


def _assert_state(js, ps):
    for f in J.SurfelState._fields:
        _assert_same(getattr(js, f), getattr(ps, f), f)


def _assert_frame(jf, pf):
    for f in ("mask", "img", "depth", "confidence"):
        _assert_same(getattr(jf, f), getattr(pf, f), "frame." + f)


WINNERS = [(True, "scatter"), (False, "scatter"), (False, "sort"), (False, "segsort")]


def test_create_matches():
    jf, pf = _frame(0)
    jc, pc = _cfgs(capacity=2 * N)
    pm = jse3.exp(jnp.asarray([0.5, 0.2, -1.0, 0.01, 0.02, -0.03]))
    js_ = J.surfel_create(jf, jnp.asarray(K), jc, pm)
    ps_ = P.surfel_create(pf, torch.from_numpy(K), pc, torch.from_numpy(np.array(pm)))
    _assert_state(js_, ps_)


@pytest.mark.parametrize("average_pts,winner,upscale", [
    (False, "scatter", 1), (False, "sort", 1), (False, "segsort", 1),
    (True, "segsort", 1), (True, "scatter", 1), (False, "segsort", 2),
    (True, "scatter", 2)])
def test_fuse_matches(average_pts, winner, upscale):
    """One fuse into the fragmented pool, and a second, same-view fuse of
    the same frame (which must match rather than append at upscale 2 too)."""
    jf, pf = _frame(1)
    jc, pc = _cfgs(capacity=3 * N, d_thresh=50.0, average_pts=average_pts,
                   winner=winner, upscale=upscale)
    base = _base_state()
    js_ = J.surfel_fuse(base, jf, jnp.asarray(POSE), jnp.asarray(K), jc)
    ps_ = P.surfel_fuse(surfel_state_from_jax(base), pf, torch.from_numpy(POSE),
                        torch.from_numpy(K), pc)
    _assert_state(js_, ps_)
    assert int(js_.hi) > int(base.hi)          # the frame appended points
    js2 = J.surfel_fuse(js_, jf, jnp.asarray(POSE), jnp.asarray(K), jc)
    ps2 = P.surfel_fuse(ps_, pf, torch.from_numpy(POSE), torch.from_numpy(K), pc)
    _assert_state(js2, ps2)


@pytest.mark.parametrize("exact,winner", WINNERS)
def test_render_matches(exact, winner):
    """Render the pool at ``inv(pose)`` and at its own extrinsics."""
    jc, pc = _cfgs(capacity=3 * N, exact_render=exact, winner=winner)
    base = _base_state()
    pb = surfel_state_from_jax(base)
    for ex in (jse3.inv(jnp.asarray(POSE)), None):
        jr = J.surfel_render(base, jnp.asarray(K), jc, extrinsics=ex)
        pr = P.surfel_render(pb, torch.from_numpy(K), pc,
                             extrinsics=None if ex is None
                             else torch.from_numpy(np.asarray(ex)))
        _assert_frame(jr, pr)
        assert np.asarray(jr.mask).any()


@pytest.mark.parametrize("exact,winner", WINNERS)
def test_fuse_render_matches(exact, winner):
    """The merged fuse + render against the JAX one, and against the port's
    own fuse followed by a render (the same bits)."""
    jf, pf = _frame(2)
    jc, pc = _cfgs(capacity=3 * N, d_thresh=50.0, average_pts=False,
                   exact_render=exact, winner=winner)
    base = _base_state()
    pb = surfel_state_from_jax(base)
    pose, kmat = torch.from_numpy(POSE), torch.from_numpy(K)
    js_, jm = J.surfel_fuse_render(base, jf, jnp.asarray(POSE), jnp.asarray(K), jc)
    ps_, pm = P.surfel_fuse_render(pb, pf, pose, kmat, pc)
    _assert_state(js_, ps_)
    _assert_frame(jm, pm)
    seq = P.surfel_fuse(pb, pf, pose, kmat, pc)
    for a, b in zip(seq, ps_):
        assert torch.equal(a, b)
    rm = P.surfel_render(seq, kmat, pc, extrinsics=se3.inv(pose))
    for f in ("mask", "img", "depth", "confidence"):
        assert torch.equal(getattr(rm, f), getattr(pm, f)), f


@pytest.mark.parametrize("op", ["compact", "pad", "transform", "stable"])
def test_pool_maintenance_matches(op):
    base = _base_state()
    pb = surfel_state_from_jax(base)
    jc, pc = _cfgs(capacity=5 * N)
    if op == "compact":
        js_, ps_ = J.surfel_compact(base, jc), P.surfel_compact(pb, pc)
        assert int(js_.hi) == int(np.asarray(base.active).sum())
    elif op == "pad":
        js_, ps_ = J.surfel_pad(base, jc), P.surfel_pad(pb, pc)
        assert js_.opts.shape[0] == 6 * N
    elif op == "transform":
        tr = jse3.exp(jnp.asarray([10.0, 0.5, -2.0, 0.1, 0.0, -0.05]))
        js_ = J.surfel_transform(base, tr)
        ps_ = P.surfel_transform(pb, torch.from_numpy(np.asarray(tr)))
    else:
        st = base._replace(conf=base.conf * 2.0)
        _assert_same(J.stable_points(st), P.stable_points(surfel_state_from_jax(st)),
                     "stable")
        return
    _assert_state(js_, ps_)


@pytest.mark.parametrize("mode", ["scatter", "sort", "segsort", "covered"])
def test_winner_primitives_match(mode):
    """Per-pixel maxima of packed keys (duplicate pixels, dropped rows
    ``pix == n``, keys -1 and up to 2^31 - 1) and the coverage OR."""
    rng = np.random.default_rng(5)
    n, m = 300, 2000
    pix = rng.integers(0, n + 1, m).astype(np.int32)
    if mode == "covered":
        pix = np.minimum(pix, n - 1)
        flag = (rng.uniform(size=m) > 0.7).astype(np.int32)
        got = P._seg_covered(torch.from_numpy(pix), torch.from_numpy(flag), n)
        ref = J._seg_covered(jnp.asarray(pix), jnp.asarray(flag), n)
        _assert_same(ref, got, "covered")
        return
    key = rng.integers(-1, 2 ** 31 - 1, m).astype(np.int32)
    key[::7] = -1
    jc, pc = _cfgs(capacity=N, winner=mode)
    ref = J._winner_kmax(jnp.asarray(pix), jnp.asarray(key), n, jc)
    got = P._winner_kmax(torch.from_numpy(pix), torch.from_numpy(key), n, pc)
    _assert_same(ref, got, "kmax")
    assert (np.asarray(ref) == -1).any() and (np.asarray(ref) > 0).any()


def _ident():
    i = np.zeros(7, np.float32)
    i[6] = 1.0
    return i


def test_wrapper_growth_and_overflow_match():
    """SurfelMap fusing frames at distinct depths: the bucket grows 2 N ->
    3 N (lossless, by re-running the fuse), then the hard capacity drops
    appends and warns once; buckets, counts and drops equal the JAX
    wrapper's after every frame."""
    rec_j, rec_p = [], []
    jf0, pf0 = _frame(0, depth=100.0)
    maps = (J.SurfelMap(jf0, K, config={"dist_thr": 0.05}, capacity=3 * N),
            P.SurfelMap(pf0, K, config={"dist_thr": 0.05}, capacity=3 * N))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for i in range(4):
            jf, pf = _frame(10 + i, depth=150.0 + 100.0 * i)
            maps[0].fuse(jf, _ident())
            maps[1].fuse(pf, _ident())
            for m, r in zip(maps, (rec_j, rec_p)):
                r.append((m.cfg.capacity, m.n_active, int(m.state.hi),
                          int(m.state.n_dropped)))
    assert rec_p == rec_j
    assert rec_p[-1][0] == 3 * N and rec_p[-1][3] > 0
    msgs = [str(w.message) for w in rec if "overflow" in str(w.message)]
    assert len(msgs) == 2 and msgs[0] == msgs[1]      # once per package
    _assert_state(maps[0].state, maps[1].state)


def test_wrapper_transform_cpy_resets_extrinsics():
    """A map made in a world frame P and copied through inv(P) renders at
    identity extrinsics like the JAX copy, and like a map made at the
    identity; the original keeps its pmat."""
    jf, pf = _frame(3, depth=120.0)
    pm = jse3.exp(jnp.asarray([4.0, -2.0, 1.5, 0.05, -0.03, 0.02]))
    jm = J.SurfelMap(jf, K, pmat=pm)
    pmap = P.SurfelMap(pf, K, pmat=np.asarray(pm))
    jr = jm.transform_cpy(jse3.inv(pm)).render()
    cp = pmap.transform_cpy(se3.inv(torch.from_numpy(np.asarray(pm))))
    assert torch.equal(cp.state.pmat, se3.identity(()))
    assert torch.equal(pmap.state.pmat, torch.from_numpy(np.asarray(pm)))
    pr = cp.render()
    _assert_frame(jr, pr)
    ident = P.SurfelMap(pf, K).render()
    np.testing.assert_allclose(pr.depth.numpy(), ident.depth.numpy(), atol=1e-3)


def test_wrapper_save_ply(tmp_path):
    """``save_ply`` writes the stable (or all active) points, divided by the
    depth scale, as the JAX wrapper does."""
    jf, pf = _frame(4)
    jm, pmap = J.SurfelMap(jf, K, depth_scale=2.0), P.SurfelMap(pf, K, depth_scale=2.0)
    for stable in (False, True):
        jm.save_ply(str(tmp_path / "j.ply"), stable=stable)
        pmap.save_ply(str(tmp_path / "p.ply"), stable=stable)
    (tmp_path / "j.ply").unlink(missing_ok=True)
    jm.state = jm.state._replace(conf=jm.state.conf * 8.0)
    pmap.state = pmap.state._replace(conf=pmap.state.conf * 8.0)
    jm.save_ply(str(tmp_path / "j.ply"))
    pmap.save_ply(str(tmp_path / "p.ply"))
    j_lines = (tmp_path / "j.ply").read_text().splitlines()
    p_lines = (tmp_path / "p.ply").read_text().splitlines()
    assert len(p_lines) == len(j_lines) > 10
    assert p_lines[:10] == j_lines[:10]          # header, vertex count
    jv = np.array([l.split() for l in j_lines[10:]], np.float64)
    pv = np.array([l.split() for l in p_lines[10:]], np.float64)
    np.testing.assert_allclose(pv, jv, rtol=2e-6, atol=1e-6 * np.abs(jv).max())
