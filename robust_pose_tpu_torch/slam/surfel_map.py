"""Surfel map: point-based fusion and frame rendering over a fixed-capacity
slot pool (port of ``robust_pose_tpu/slam/surfel_map.py``).

The pool keeps the JAX package's layout and semantics: arrays of
``capacity`` slots plus one frame of scratch margin, new points appended as
one contiguous block at the high-water mark ``hi`` (pruned slots stay
inactive holes until ``surfel_compact``), overflow counted in
``n_dropped``, and a per-pixel render winner chosen as the maximum of a key
(exact two-pass argmax of the confidence, or one packed
``(quantized conf << slot_bits) | slot`` key). ``hi``, ``tick`` and
``n_dropped`` are 0-d device tensors, so a fuse needs no host sync; the
append writes rows ``hi + arange(n)`` with ``index_copy``.

Every function is pure: it returns new tensors and leaves its input state
as it was, so the ``SurfelMap`` wrapper can re-run a fuse from the kept
pre-fuse state when a capacity bucket overflows.

The three winner modes compute the same per-pixel maximum: ``"scatter"``
with one ``scatter_reduce`` (amax), ``"sort"`` and ``"segsort"`` through a
lexicographic (pixel, key) sort, done as one ``torch.sort`` of the pair
packed into int64. They give the same bits.

Projections go through ``ops.geometry.project2image``, whose products are
written out elementwise: on the CPU they round as the JAX package's do, so
the pixel each surfel falls on, and every integer and boolean output here,
is the JAX package's bit for bit.
"""
from __future__ import annotations

import copy
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from robust_pose_tpu_torch import se3
from robust_pose_tpu_torch.ops.geometry import (
    create_img_coords,
    inv_upper3,
    matvec3,
    project2image,
)
from robust_pose_tpu_torch.slam.frame import Frame, make_frame

Tensor = torch.Tensor


class SurfelConfig(NamedTuple):
    capacity: int
    img_shape: Tuple[int, int]        # (H, W)
    conf_thr: float = 7.0
    t_max: int = 15
    d_thresh: float = 100.0
    average_pts: bool = True
    exact_render: bool = True         # exact two-pass winner, else packed key
    winner: str = "scatter"           # "scatter", "sort" or "segsort"
    upscale: int = 1                  # fuse-time correspondence supersampling


class SurfelState(NamedTuple):
    opts: Tensor       # (ALLOC, 3) world-space points
    rgb: Tensor        # (ALLOC, 3)
    conf: Tensor       # (ALLOC,)
    t_created: Tensor  # (ALLOC,) int32
    active: Tensor     # (ALLOC,) bool
    tick: Tensor       # () int32
    pmat: Tensor       # (7,) map extrinsics
    n_dropped: Tensor  # () int32, appends lost to capacity overflow
    hi: Tensor         # () int32, 1 + the largest slot written


# ---------------------------------------------------------------------------
# per-pixel maxima
# ---------------------------------------------------------------------------

def _scatter_set(base: Tensor, idx: Tensor, vals: Tensor) -> Tensor:
    """``base.at[idx].set(vals, mode="drop")`` for unique ``idx`` in
    [0, n) and any number of ``idx == n`` rows, which drop."""
    out = torch.cat([base, base[:1]])
    out.scatter_(0, idx.long(), vals)
    return out[:-1]


def _scatter_max(base: Tensor, idx: Tensor, vals: Tensor) -> Tensor:
    """``base.at[idx].max(vals, mode="drop")`` for ``idx`` in [0, n]."""
    out = torch.cat([base, base[:1]])
    out.scatter_reduce_(0, idx.long(), vals, reduce="amax")
    return out[:-1]


def _full(n: int, value, like: Tensor, dtype=torch.int32) -> Tensor:
    return torch.full((n,), value, dtype=dtype, device=like.device)


def _sort_pairs(pix: Tensor, key: Tensor):
    """``jax.lax.sort((pix, key), num_keys=2)`` for int32 ``pix >= 0`` and
    int32 ``key``: one sort of ``pix << 32 | (key + 2^31)`` in int64."""
    s = torch.sort((pix.long() << 32) | (key.long() + 2 ** 31)).values
    return (s >> 32).int(), ((s & 0xFFFFFFFF) - 2 ** 31).int()


def _is_tail(ps: Tensor) -> Tensor:
    return torch.cat([ps[1:] != ps[:-1],
                      torch.ones(1, dtype=torch.bool, device=ps.device)])


def _seg_kmax(pix: Tensor, key: Tensor, n: int) -> Tensor:
    """Per-pixel max of ``key`` (``pix == n`` drops), -1 where a pixel has
    no candidate, by the double sort: sort by (pixel, key), so each pixel's
    segment tail holds its max; move the tails to the front in pixel order
    with a second sort; write the first n rows."""
    ps, ks = _sort_pairs(pix, key)
    skey = torch.where(_is_tail(ps), ps, n)
    order = torch.sort(skey).indices[:n]
    return _scatter_set(_full(n, -1, pix), skey[order], ks[order])


def _seg_covered(pix: Tensor, flag: Tensor, n: int) -> Tensor:
    """Per-pixel OR of the 0/1 ``flag`` over candidates (``pix`` in
    [0, n)): the flag rides the LSB of ``pix << 1``, so each pixel's
    segment max carries the OR."""
    s = torch.sort((pix << 1) | flag).values
    comp = torch.where(_is_tail(s >> 1), s, (n << 1) | 1)
    s2 = torch.sort(comp).values[:n]
    return _scatter_set(_full(n, 0, pix), s2 >> 1, s2 & 1) > 0


def _winner_kmax(pix: Tensor, key: Tensor, n: int, cfg: SurfelConfig) -> Tensor:
    """Per-pixel max of ``key`` over candidates (``pix == n`` drops), -1
    where none, by the configured winner mode."""
    if cfg.winner == "segsort":
        return _seg_kmax(pix, key, n)
    if cfg.winner == "sort":
        ps, ks = _sort_pairs(pix, key)
        return _scatter_set(_full(n, -1, pix), torch.where(_is_tail(ps), ps, n), ks)
    return _scatter_max(_full(n, -1, pix), pix, key)


def _slot_bits(alloc: int) -> int:
    return max(int(alloc - 1).bit_length(), 1)


def _pack(conf: Tensor, ids: Tensor, ok: Tensor, slot_bits: int) -> Tensor:
    """int32 key ``(quantized conf << slot_bits) | slot``, -1 where not ok."""
    qmax = (1 << (31 - slot_bits)) - 1
    q = torch.clamp((conf * qmax).to(torch.int32), 0, qmax)
    return torch.where(ok, (q << slot_bits) | ids, -1)


# ---------------------------------------------------------------------------
# pool operations
# ---------------------------------------------------------------------------

def _world_points(depth: Tensor, kmat: Tensor, pose: Tensor,
                  img_coords: Tensor) -> Tensor:
    """Back-project a (1, H, W, 1) depth and move to world coords: (N, 3)."""
    kinv = inv_upper3(kmat)
    return se3.act(pose[None], depth.reshape(-1, 1) * matvec3(kinv, img_coords))


def _pad(x: Tensor, pad: int) -> Tensor:
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def _div(x: Tensor, c: float) -> Tensor:
    """``x / c`` as a true division on every device (a Python-scalar
    divisor becomes a multiplication by its reciprocal on the card)."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def surfel_create(frame: Frame, kmat: Tensor, cfg: SurfelConfig,
                  pmat: Optional[Tensor] = None) -> SurfelState:
    """The map of one frame: its points, colours, confidences / conf_thr,
    its mask as the active set, in slots 0..N-1 of a zeroed pool."""
    h, w = cfg.img_shape
    n = h * w
    if cfg.capacity < n:
        raise ValueError(f"surfel capacity {cfg.capacity} < one frame ({n})")
    dev = frame.img.device
    pmat = se3.identity((), device=dev) if pmat is None else pmat
    opts = _world_points(frame.depth, kmat, pmat,
                         create_img_coords(h, w, device=dev))
    pad = cfg.capacity          # alloc = capacity + one frame of margin
    return SurfelState(
        opts=_pad(opts, pad),
        rgb=_pad(frame.img.reshape(-1, 3), pad),
        conf=_pad(_div(frame.confidence.reshape(-1), cfg.conf_thr), pad),
        t_created=torch.zeros(n + pad, dtype=torch.int32, device=dev),
        active=_pad(frame.mask.reshape(-1), pad),
        tick=torch.zeros((), dtype=torch.int32, device=dev),
        pmat=pmat,
        n_dropped=torch.zeros((), dtype=torch.int32, device=dev),
        hi=torch.tensor(n, dtype=torch.int32, device=dev),
    )


def surfel_pad(state: SurfelState, cfg: SurfelConfig) -> SurfelState:
    """Grow the pool to ``cfg.capacity`` slots + margin by zero padding
    (slot indices are kept)."""
    h, w = cfg.img_shape
    pad = cfg.capacity + h * w - state.opts.shape[0]
    assert pad >= 0
    return state._replace(opts=_pad(state.opts, pad), rgb=_pad(state.rgb, pad),
                          conf=_pad(state.conf, pad),
                          t_created=_pad(state.t_created, pad),
                          active=_pad(state.active, pad))


def surfel_compact(state: SurfelState, cfg: SurfelConfig) -> SurfelState:
    """Re-pack the active surfels into a contiguous prefix, in slot order,
    and reset ``hi`` to the live count."""
    alloc = state.opts.shape[0]
    act = state.active
    rank = torch.cumsum(act, 0, dtype=torch.int32) - 1
    n_live = rank[-1] + 1
    ids = torch.arange(alloc, dtype=torch.int32, device=act.device)
    src = _scatter_set(_full(alloc, 0, act), torch.where(act, rank, alloc), ids)
    rows = torch.cat([state.opts, state.rgb, state.conf[:, None],
                      state.t_created.to(state.opts.dtype)[:, None]], dim=-1)
    packed = rows[src.long()]
    live = ids < n_live
    return state._replace(
        opts=torch.where(live[:, None], packed[:, :3], 0.0),
        rgb=torch.where(live[:, None], packed[:, 3:6], 0.0),
        conf=torch.where(live, packed[:, 6], 0.0),
        t_created=torch.where(live, packed[:, 7].to(torch.int32), 0),
        active=live,
        hi=n_live.to(torch.int32),
    )


def _linear_weights(m: int, n: int, device) -> Tensor:
    """(m, n) weights of ``jax.image.resize(..., "linear")`` from m to n
    samples along one axis (triangle kernel at half-pixel centres,
    renormalized at the borders)."""
    inv_scale = m / n
    sample = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(m, dtype=torch.float32, device=device)[:, None]).abs()
    wts = torch.clamp(1.0 - x, min=0.0)
    total = wts.sum(0, keepdim=True)
    wts = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                      wts / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], wts, 0.0)


def _resize_linear(x: Tensor, hf: int, wf: int) -> Tensor:
    """(1, H, W, C) -> (1, hf, wf, C), as ``jax.image.resize`` linear."""
    _, h, w, _ = x.shape
    y = torch.einsum("bhwc,hH->bHwc", x, _linear_weights(h, hf, x.device))
    return torch.einsum("bHwc,wW->bHWc", y, _linear_weights(w, wf, x.device))


def _fuse_core(state: SurfelState, frame: Frame, pose: Tensor, kmat: Tensor,
               cfg: SurfelConfig, with_winner: bool = False):
    """Shared fuse body; returns (new_state, aux), aux carrying the pool
    projection and the append-block bookkeeping that ``surfel_fuse_render``
    reuses. With ``with_winner`` (packed-key render, ``upscale`` 1) the
    render's pool winner is found here from the same projection."""
    h, w = cfg.img_shape
    n = h * w
    u = cfg.upscale
    dev = state.opts.device
    opts_new = _world_points(frame.depth, kmat, pose, create_img_coords(h, w, device=dev))
    rgb_new = frame.img.reshape(-1, 3)
    fmask = frame.mask.reshape(-1)
    conf_new = torch.full((n,), 1.0 / cfg.conf_thr, dtype=state.conf.dtype, device=dev)

    pose_inv = se3.inv(pose)
    if u > 1:
        # supersampled correspondence grid: bilinearly upsampled frame and
        # u-scaled intrinsics; appended points stay at base resolution
        hf, wf, nf = h * u, w * u, n * u * u
        kf = kmat * kmat.new_tensor([[u], [u], [1.0]])
        depth_f = _resize_linear(frame.depth, hf, wf)
        rgb_f = _resize_linear(frame.img, hf, wf)
        # jax.image.resize "nearest" at an integer factor repeats pixels
        mask_f = frame.mask.repeat_interleave(u, 1).repeat_interleave(u, 2)
        opts_fine = _world_points(depth_f, kf, pose, create_img_coords(hf, wf, device=dev))
        rgb_fine, fmask_fine = rgb_f.reshape(-1, 3), mask_f.reshape(-1)
        ipts, inb = project2image(state.opts, kf, (hf, wf), pose_inv)
    else:
        hf, wf, nf = h, w, n
        opts_fine, rgb_fine, fmask_fine = opts_new, rgb_new, fmask
        ipts, inb = project2image(state.opts, kmat, (h, w), pose_inv)
    bidx = inb & state.active
    # match by pixel quantization (round half to even, as jnp.round)
    qx = torch.round(ipts[:, 0] - 0.5).to(torch.int32)
    qy = torch.round(ipts[:, 1] - 0.5).to(torch.int32)
    midx = torch.clamp(qy * wf + qx, 0, nf - 1)

    corr = torch.cat([opts_fine, rgb_fine, fmask_fine[:, None].to(opts_fine.dtype)],
                     dim=-1)[midx.long()]                       # (ALLOC, 7)
    opts_corr, rgb_corr, fmask_corr = corr[:, :3], corr[:, 3:6], corr[:, 6] > 0

    # depth-outlier rejection in world z
    depth_ok = (opts_corr[:, 2] - state.opts[:, 2]).abs() < cfg.d_thresh
    matched = bidx & depth_ok & fmask_corr

    # confidence-weighted running average
    alloc = state.opts.shape[0]
    ccor = torch.full((alloc,), 1.0 / cfg.conf_thr, dtype=state.conf.dtype, device=dev)
    cold = state.conf
    if cfg.average_pts:
        denom = torch.clamp(cold + ccor, min=1e-12)[:, None]
        opts_upd = (cold[:, None] * state.opts + ccor[:, None] * opts_corr) / denom
        rgb_upd = (cold[:, None] * state.rgb + ccor[:, None] * rgb_corr) / denom
        opts = torch.where(matched[:, None], opts_upd, state.opts)
        rgb = torch.where(matched[:, None], rgb_upd, state.rgb)
    else:
        opts, rgb = state.opts, state.rgb
    conf = torch.where(matched, torch.clamp(cold + ccor, 0.0, 1.0), cold)

    tick = state.tick + 1
    # prune unstable aged surfels
    keep = state.active & ((conf >= 1.0) | (tick - state.t_created < cfg.t_max))

    # pixels already covered by a matched surfel; for u > 1 the fine-grid
    # coverage max-pools back to the base grid
    flag = matched.to(torch.int32)
    if cfg.winner == "segsort":
        covered_f = _seg_covered(midx, flag, nf)
    elif cfg.winner == "sort":
        covered_f = _winner_kmax(midx, flag, nf, cfg) > 0
    else:
        covered_f = _scatter_max(_full(nf, 0, flag), midx, flag) > 0
    if u > 1:
        covered = covered_f.reshape(h, u, w, u).any(dim=3).any(dim=1).reshape(-1)
    else:
        covered = covered_f
    new_mask = ~covered & fmask

    slot_bits = _slot_bits(alloc)
    slot_ids = torch.arange(alloc, dtype=torch.int32, device=dev)
    pool_kmax = None
    if (with_winner and cfg.winner in ("scatter", "segsort")
            and not cfg.exact_render and slot_bits <= 23 and u == 1):
        px = torch.clamp(ipts[:, 0].to(torch.int32), 0, w - 1)
        py = torch.clamp(ipts[:, 1].to(torch.int32), 0, h - 1)
        idx = torch.where(inb, py * w + px, n)                 # n drops
        vrender = inb & keep & (slot_ids < state.hi)
        key = _pack(conf, slot_ids, vrender, slot_bits)
        if cfg.winner == "segsort":
            pool_kmax = _seg_kmax(idx, key, n)
        else:
            pool_kmax = _scatter_max(_full(n, -1, key), idx, key)

    # append at hi: compact the new points into a contiguous block and
    # write it at rows hi .. hi + n - 1 (the pool has n rows of margin)
    rank = torch.cumsum(new_mask, 0, dtype=torch.int32) - 1
    n_new = rank[-1] + 1
    space = torch.clamp(cfg.capacity - state.hi, min=0)
    n_placed = torch.minimum(n_new, space)
    placed = new_mask & (rank < space)
    row_ids = torch.arange(n, dtype=torch.int32, device=dev)
    src = _scatter_set(_full(n, 0, rank), torch.where(placed, rank, n), row_ids)
    block = torch.cat([opts_new, rgb_new, conf_new[:, None]], dim=-1)[src.long()]
    blk_active = row_ids < n_placed

    hi0 = state.hi
    rows = (hi0 + row_ids).long()
    opts = opts.index_copy(0, rows, block[:, :3])
    rgb = rgb.index_copy(0, rows, block[:, 3:6])
    conf = conf.index_copy(0, rows, block[:, 6])
    t_created = state.t_created.index_copy(0, rows, tick * blk_active)
    active = keep.index_copy(0, rows, blk_active)

    new_state = SurfelState(opts, rgb, conf, t_created, active, tick, state.pmat,
                            state.n_dropped + (n_new - n_placed), hi0 + n_placed)
    aux = dict(ipts=ipts, inb=inb, src=src, blk_active=blk_active,
               placed=placed, rank=rank, hi0=hi0, pool_kmax=pool_kmax)
    return new_state, aux


def surfel_fuse(state: SurfelState, frame: Frame, pose: Tensor, kmat: Tensor,
                cfg: SurfelConfig) -> SurfelState:
    """Fuse one frame into the map.

    :param pose: (7,) camera-to-world pose of the frame
    """
    return _fuse_core(state, frame, pose, kmat, cfg)[0]


def _winner_frame(state: SurfelState, slot_img: Tensor, T: Tensor,
                  h: int, w: int) -> Frame:
    """The rendered frame of a per-pixel winner slot image (-1: none): the
    winners' colours, confidences and camera-frame depth under ``T``."""
    alloc = state.opts.shape[0]
    have = slot_img >= 0
    sl = torch.clamp(slot_img, 0, alloc - 1).long()
    win = torch.cat([state.opts, state.rgb, state.conf[:, None]], dim=-1)[sl]
    zcam = se3.act(T[None], win[:, :3])[:, 2]
    return make_frame(
        torch.where(have[:, None], win[:, 3:6], 0.0).reshape(1, h, w, 3),
        depth=torch.where(have, zcam, 0.0).reshape(1, h, w, 1),
        mask=have.reshape(1, h, w, 1),
        confidence=torch.where(have, win[:, 6], 0.0).reshape(1, h, w, 1))


def surfel_fuse_render(state: SurfelState, frame: Frame, pose: Tensor,
                       kmat: Tensor, cfg: SurfelConfig) -> Tuple[SurfelState, Frame]:
    """Fuse one frame and render the post-fuse map at ``inv(pose)``, the
    view the next frame-to-model step tracks against, reusing the fuse's
    pool projection (with ``average_pts`` off the fuse moves no point; the
    appended block projects back onto its own source pixels). Requires
    ``average_pts`` False and ``upscale`` 1; the same bits as
    ``surfel_render(surfel_fuse(...), extrinsics=inv(pose))``."""
    if cfg.average_pts or cfg.upscale != 1:
        raise ValueError("surfel_fuse_render requires average_pts=False, upscale=1")
    h, w = cfg.img_shape
    n = h * w
    new_state, aux = _fuse_core(state, frame, pose, kmat, cfg, with_winner=True)
    alloc = new_state.opts.shape[0]
    dev = new_state.opts.device
    slot_ids = torch.arange(alloc, dtype=torch.int32, device=dev)

    ipts = aux["ipts"]
    hi0 = aux["hi0"]
    valid = aux["inb"] & new_state.active & (slot_ids < hi0)
    px = torch.clamp(ipts[:, 0].to(torch.int32), 0, w - 1)
    py = torch.clamp(ipts[:, 1].to(torch.int32), 0, h - 1)
    pix = torch.where(valid, py * w + px, n)

    slot_bits = _slot_bits(alloc)
    blk_ids = hi0 + torch.arange(n, dtype=torch.int32, device=dev)
    blk_conf_rows = new_state.conf[blk_ids.long()]
    blk_pix = torch.where(aux["blk_active"], aux["src"], n)
    if cfg.exact_render or slot_bits > 23:
        # exact two-pass winner over the pool and the appended block
        conf_max = _full(n, -float("inf"), pix, new_state.conf.dtype)
        conf_max = _scatter_max(conf_max, pix, new_state.conf)
        conf_max = _scatter_max(conf_max, blk_pix, blk_conf_rows)
        is_max = valid & (new_state.conf == conf_max[torch.clamp(pix, 0, n - 1).long()])
        slot_img = _scatter_max(_full(n, -1, pix), pix, torch.where(is_max, slot_ids, -1))
        bis_max = aux["blk_active"] & (
            blk_conf_rows == conf_max[torch.clamp(blk_pix, 0, n - 1).long()])
        slot_img = _scatter_max(slot_img, blk_pix, torch.where(bis_max, blk_ids, -1))
    else:
        if aux["pool_kmax"] is not None:
            # the pool's winners came with the fuse; block row j is the j-th
            # placed frame pixel, so in pixel space the block's keys are
            # elementwise: conf 1/conf_thr, slot hi0 + rank
            q_new = torch.tensor(1.0 / cfg.conf_thr, dtype=new_state.conf.dtype,
                                 device=dev)
            blk_img = _pack(q_new, hi0 + aux["rank"], aux["placed"], slot_bits)
            kmax = torch.maximum(aux["pool_kmax"], blk_img)
        else:
            key = _pack(new_state.conf, slot_ids, valid, slot_bits)
            blk_key = _pack(blk_conf_rows, blk_ids, aux["blk_active"], slot_bits)
            kmax = _winner_kmax(torch.cat([pix, blk_pix]), torch.cat([key, blk_key]),
                                n, cfg)
        slot_img = torch.where(kmax >= 0, kmax & ((1 << slot_bits) - 1), -1)
    return new_state, _winner_frame(new_state, slot_img, se3.inv(pose), h, w)


def surfel_transform(state: SurfelState, tr: Tensor) -> SurfelState:
    """Rigidly transform every surfel."""
    return state._replace(opts=se3.act(tr[None], state.opts))


def surfel_render(state: SurfelState, kmat: Tensor, cfg: SurfelConfig,
                  extrinsics: Optional[Tensor] = None) -> Frame:
    """Render (image, depth, mask, confidence) at ``extrinsics`` (default:
    the map's ``pmat``): per pixel the highest-confidence active surfel that
    projects into it; holes stay 0 and ``mask`` carries validity (the
    reference's inpainting only fills NaNs, so it changes nothing here)."""
    h, w = cfg.img_shape
    n = h * w
    alloc = state.opts.shape[0]
    T = state.pmat if extrinsics is None else extrinsics
    ipts, inb = project2image(state.opts, kmat, (h, w), T)
    valid = inb & state.active
    px = torch.clamp(ipts[:, 0].to(torch.int32), 0, w - 1)
    py = torch.clamp(ipts[:, 1].to(torch.int32), 0, h - 1)
    pix = torch.where(valid, py * w + px, n)                    # n drops
    slot_ids = torch.arange(alloc, dtype=torch.int32, device=pix.device)

    slot_bits = _slot_bits(alloc)
    if cfg.exact_render or slot_bits > 23:
        # exact argmax: the confidence max, then the largest slot among
        # the candidates that reach it
        conf_max = _scatter_max(_full(n, -float("inf"), pix, state.conf.dtype),
                                pix, state.conf)
        is_max = valid & (state.conf == conf_max[torch.clamp(pix, 0, n - 1).long()])
        slot_img = _scatter_max(_full(n, -1, pix), pix, torch.where(is_max, slot_ids, -1))
    else:
        kmax = _winner_kmax(pix, _pack(state.conf, slot_ids, valid, slot_bits), n, cfg)
        slot_img = torch.where(kmax >= 0, kmax & ((1 << slot_bits) - 1), -1)
    return _winner_frame(state, slot_img, T, h, w)


def stable_points(state: SurfelState) -> Tensor:
    """Mask of stable surfels (conf >= 1)."""
    return state.active & (state.conf >= 1.0)


def _f32(x, device) -> Tensor:
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x, np.float32)
                           ).to(device, torch.float32)


class SurfelMap:
    """Host-side wrapper over the pool functions (fuse / render /
    transform_cpy / save_ply).

    The pool lives at a capacity bucket (2x frame unless ``initial_bucket``
    says otherwise), doubling on demand up to ``capacity``. Overflow inside
    a bucket is lossless: the fuse is re-run from the pre-fuse state after
    compaction or growth. Only at the hard ``capacity`` do appends drop,
    counted in ``n_dropped`` and warned about once."""

    def __init__(self, frame: Frame, kmat, config: Optional[dict] = None,
                 pmat=None, capacity: Optional[int] = None,
                 depth_scale: float = 1.0):
        config = config or {}
        h, w = frame.img.shape[1:3]
        self._n = h * w
        self.max_capacity = capacity or 8 * h * w
        bucket = int(config.get("initial_bucket") or
                     max(min(self.max_capacity, 2 * self._n), self._n))
        self.cfg = SurfelConfig(
            capacity=max(min(bucket, self.max_capacity), self._n),
            img_shape=(h, w),
            d_thresh=config.get("dist_thr", 100.0),
            average_pts=config.get("average_pts", True),
            exact_render=bool(config.get("exact_render", True)),
            winner=str(config.get("winner", "scatter")),
            upscale=int(config.get("upscale", 1)))
        dev = frame.img.device
        self.kmat = _f32(kmat, dev)
        self.depth_scale = depth_scale
        self._warned_overflow = False
        pm = None if pmat is None else _f32(pmat, dev).reshape(7)
        self.state = surfel_create(frame, self.kmat, self.cfg, pm)
        # host-side upper bound on state.hi (a fuse appends at most one
        # frame): while it leaves headroom, post_fuse reads no counters
        self._hi_upper = self._n

    def _grow(self) -> None:
        self.cfg = self.cfg._replace(
            capacity=min(self.max_capacity, 2 * self.cfg.capacity))

    @staticmethod
    def _counters(state):
        """(n_dropped, hi, active count) in one device-to-host copy."""
        return tuple(torch.stack([state.n_dropped, state.hi,
                                  state.active.sum(dtype=torch.int32)]).tolist())

    def post_fuse(self, prev_state: SurfelState, redo_fn=None,
                  frames: int = 1) -> None:
        """Pool maintenance after ``frames`` fuses: lossless overflow
        recovery and fragmentation control.

        :param prev_state: the state before the fuse(s)
        :param redo_fn: ``redo_fn(prev_state, cfg) -> new state`` re-runs
            the fuse(s) after the pre-fuse state was compacted or grown
        """
        # fast path: hi grows by at most one frame a fuse, so while the
        # bound leaves a quarter frame of headroom nothing can overflow
        self._hi_upper += frames * self._n
        if self._hi_upper + self._n // 4 <= self.cfg.capacity:
            return

        n_dropped, hi, n_active = self._counters(self.state)
        new_drops = n_dropped - int(prev_state.n_dropped)
        while new_drops > 0 and redo_fn is not None:
            _, hi_p, act_p = self._counters(prev_state)
            if hi_p - act_p > self._n // 4:
                prev_state = surfel_compact(prev_state, self.cfg)
            elif self.cfg.capacity < self.max_capacity:
                self._grow()
                prev_state = surfel_pad(prev_state, self.cfg)
            else:
                break
            self.state = redo_fn(prev_state, self.cfg)
            n_dropped, hi, n_active = self._counters(self.state)
            new_drops = n_dropped - int(prev_state.n_dropped)
        if new_drops > 0 and not self._warned_overflow:
            warnings.warn(
                f"surfel map overflow: {n_dropped} appends dropped at the "
                f"capacity limit ({self.max_capacity}); raise "
                f"slam.map_capacity to avoid tracking-quality degradation")
            self._warned_overflow = True
        # housekeeping before the next fuse could overflow: compact if that
        # frees enough, else grow the bucket
        if hi + self._n // 4 > self.cfg.capacity:
            if hi - n_active > self._n // 4:
                self.state = surfel_compact(self.state, self.cfg)
                hi = n_active
            elif self.cfg.capacity < self.max_capacity:
                self._grow()
                self.state = surfel_pad(self.state, self.cfg)
        self._hi_upper = hi

    def fuse(self, frame: Frame, pose) -> None:
        pose = _f32(pose, self.kmat.device).reshape(7)
        prev = self.state
        self.state = surfel_fuse(prev, frame, pose, self.kmat, self.cfg)
        self.post_fuse(prev, lambda st, cfg: surfel_fuse(st, frame, pose,
                                                         self.kmat, cfg))

    def render(self, kmat=None, extrinsics=None) -> Frame:
        dev = self.kmat.device
        kmat = self.kmat if kmat is None else _f32(kmat, dev)
        ex = None if extrinsics is None else _f32(extrinsics, dev).reshape(7)
        return surfel_render(self.state, kmat, self.cfg, ex)

    def transform_cpy(self, tr) -> "SurfelMap":
        """Transformed copy; its extrinsics reset to the identity (the
        reference rebuilds the copy without ``pmat``), so a later
        ``render()`` projects the transformed points directly."""
        new = copy.copy(self)
        dev = self.kmat.device
        new.state = surfel_transform(self.state, _f32(tr, dev).reshape(7))._replace(
            pmat=se3.identity((), device=dev))
        return new

    @property
    def n_active(self) -> int:
        return int(self.state.active.sum())

    def save_ply(self, path: str, stable: bool = True) -> None:
        from robust_pose_tpu_torch.utils.ply import save_ply as _save

        sel = (stable_points(self.state) if stable else self.state.active).cpu().numpy()
        opts = self.state.opts.cpu().numpy()[sel] / self.depth_scale
        rgb = self.state.rgb.cpu().numpy()[sel]
        if len(opts) > 0:
            _save(opts, rgb, path)
