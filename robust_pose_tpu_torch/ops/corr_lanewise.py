"""Lane-wise RAFT correlation lookup over the transposed volume: the
forward kernel (K4) and its backward kernel (K5), both CUDA C++, each one
launch for every level of a pyramid, in one ``torch.autograd.Function`` over
the pyramid, with the plain PyTorch version of each.

Replaces ``robust_pose_tpu/ops/pallas_lookup_lanewise.py``:
``_lanewise_kernel`` (forward) and ``_lanewise_bwd_kernel`` (its custom
VJP), reached through ``lanewise_lookup_level`` / ``lanewise_lookup``, and
``build_corr_pyramid_t``. The kernel source, ``csrc/corr_lanewise.cu``,
states what bounds each kernel and how the design answers it.

Contract (the JAX package's): the volume ``corr_t`` is (B, Hl, Wl, N), N
query pixels minor; coords (B, N, 2) are (x, y) in level-0 pixels and are
divided by ``level_scale``; the output is (B, D*D, N) f32, dy-major,
D = 2r + 1; the backward gives dcorr in the volume's dtype and
dcoords = [dcx, dcy] / level_scale.

The pyramid entries take the levels of ``build_corr_pyramid_t`` (level l
the pooled half of level l - 1, read at ``level_scale * 2^l``), fill one
(B, L*81, N) f32 buffer, level l at channels 81 l .. 81 l + 80, and return
its per-level (B, 81, N) views, the list RAFT's motion encoder takes. The
backward takes the cotangent of that buffer, writes every element of every
level's dcorr once (they come from ``torch.empty``) and sums dcoords over
the levels in level order. The one-level functions are the one-level case
of the same kernels.

The plain versions serve the CPU (where the wrappers take them) and
chip_smoke.py's comparison on the card. The forward gathers the
(D+1) x (D+1) taps of each window; the backward applies the explicit
cotangent formulas of the Pallas backward (it is not autograd of the plain
forward, so the two are checked against each other).
"""
from __future__ import annotations

import ctypes
import math

import torch

from robust_pose_tpu_torch.device import plain_or_cuda
from robust_pose_tpu_torch.ops import _build

Tensor = torch.Tensor

RADIUS = 4
D = 2 * RADIUS + 1
MAX_LEVELS = 4     # levels one launch takes (RAFT's pyramid has 4)

launches = 0       # K4 launches (one per call, whatever the levels)
bwd_launches = 0   # K5 launches (likewise)

# the 4 level pointers, coords, out, B, N, H0, W0, L, radius, 1 / level 0's
# scale, dtype, stream
_FWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# the 4 level pointers, coords, g, the 4 dcorr pointers, dcoords, then as
# the forward
_BWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def build_corr_pyramid_t(fmap1: Tensor, fmap2: Tensor, num_levels: int = 4,
                         dtype=None):
    """All-pairs correlation + pyramid, transposed for the lane-wise lookup.

    :param fmap1, fmap2: (B, H, W, C) 1/8-res feature maps
    :param dtype: storage dtype of the volume
    :return: list of (B, Hl, Wl, N) volumes, N = H*W query pixels minor
    """
    b, h, w, c = fmap1.shape
    f1 = fmap1.reshape(b, h * w, c)
    f2 = fmap2.reshape(b, h * w, c)
    # corr_t[b, m, n] = <f2[m], f1[n]> / sqrt(c)
    corr = torch.matmul(f2, f1.transpose(1, 2)) / math.sqrt(c)
    if dtype is not None:
        corr = corr.to(dtype)
    pyramid = [corr.reshape(b, h, w, h * w)]
    for _ in range(num_levels - 1):
        prev = pyramid[-1]
        _, hl, wl, n = prev.shape
        p = prev[:, :(hl // 2) * 2, :(wl // 2) * 2]      # floor semantics
        pyramid.append(p.reshape(b, hl // 2, 2, wl // 2, 2, n).mean(dim=(2, 4)))
    return pyramid


def _window(coords: Tensor, level_scale: float, hl: int, wl: int,
            radius: int):
    """Per-query window geometry: the (D+1) tap rows and columns, whether
    each lies inside the level, and the bilinear fractions (B, N)."""
    c = coords.float() / float(level_scale)
    cx, cy = c[..., 0], c[..., 1]
    x0, y0 = torch.floor(cx), torch.floor(cy)
    off = torch.arange(2 * radius + 2, dtype=torch.float32,
                       device=coords.device) - radius
    ys = y0[..., None] + off                           # (B, N, D+1)
    xs = x0[..., None] + off
    rowok = (ys >= 0) & (ys < hl)
    colok = (xs >= 0) & (xs < wl)
    return ys, xs, rowok, colok, cx - x0, cy - y0


def _taps(corr_t: Tensor, ys, xs, rowok, colok):
    """T[b, i, j, n] = corr_t[b, ys[b,n,i], xs[b,n,j], n] in f32, zero
    outside the level; also the flat (B, (D+1)^2, N) tap index and mask."""
    b, hl, wl, n = corr_t.shape
    p = ys.shape[-1]
    ok = rowok[..., :, None] & colok[..., None, :]       # (B, N, P, P)
    iy = torch.where(rowok, ys, 0.0).long()
    ix = torch.where(colok, xs, 0.0).long()
    idx = (iy[..., :, None] * wl + ix[..., None, :]).reshape(b, n, p * p)
    idx = idx.transpose(1, 2)                            # (B, P*P, N)
    ok = ok.reshape(b, n, p * p).transpose(1, 2)
    vals = torch.gather(corr_t.reshape(b, hl * wl, n), 1, idx).float()
    vals = torch.where(ok, vals, 0.0)
    return vals.reshape(b, p, p, n), idx, ok


def lanewise_fwd_plain(corr_t: Tensor, coords: Tensor, radius: int,
                       level_scale: float) -> Tensor:
    """Plain K4: (B, D*D, N) f32. Rows first, then columns, each step a
    product pair and a sum rounded separately, as the kernel does."""
    b, hl, wl, n = corr_t.shape
    d = 2 * radius + 1
    ys, xs, rowok, colok, wx, wy = _window(coords, level_scale, hl, wl, radius)
    T, _, _ = _taps(corr_t, ys, xs, rowok, colok)            # (B, P, P, N)
    rowok, colok = rowok.transpose(1, 2), colok.transpose(1, 2)   # (B, P, N)
    wx, wy = wx[:, None], wy[:, None]                        # (B, 1, N)
    w0 = torch.where(rowok[:, :d], 1.0 - wy, 0.0)[:, :, None]   # (B, D, 1, N)
    w1 = torch.where(rowok[:, 1:], wy, 0.0)[:, :, None]
    A = w0 * T[:, :d] + w1 * T[:, 1:]                        # (B, D, P, N)
    wc0 = torch.where(colok[:, :d], 1.0 - wx, 0.0)[:, None]  # (B, 1, D, N)
    wc1 = torch.where(colok[:, 1:], wx, 0.0)[:, None]
    out = wc0 * A[:, :, :d] + wc1 * A[:, :, 1:]              # (B, D, D, N)
    return out.reshape(b, d * d, n)


def lanewise_bwd_plain(corr_t: Tensor, coords: Tensor, g: Tensor,
                       radius: int, level_scale: float):
    """Plain K5: the explicit cotangents of K4.

    gx[dy, j'] = wx g[dy, j'-1] + (1-wx) g[dy, j'], gxp[dy, j'] = g[dy, j'-1]
    - g[dy, j'] (g zero outside the window); dcorr at tap (i', j') =
    wy gx[i'-1, j'] + (1-wy) gx[i', j']; dcy = sum (T[dy+1] - T[dy]) gx[dy]
    and dcx = sum A[dy] gxp[dy] over the in-level columns.

    :param g: (B, D*D, N) cotangent of the output
    :return: dcorr (B, Hl, Wl, N) in corr_t's dtype, dcoords (B, N, 2) f32
    """
    b, hl, wl, n = corr_t.shape
    d = 2 * radius + 1
    ys, xs, rowok, colok, wx, wy = _window(coords, level_scale, hl, wl, radius)
    T, idx, ok = _taps(corr_t, ys, xs, rowok, colok)
    rowok, colok = rowok.transpose(1, 2), colok.transpose(1, 2)
    wx, wy = wx[:, None, None], wy[:, None, None]            # (B, 1, 1, N)
    gp = torch.nn.functional.pad(g.float().reshape(b, d, d, n),
                                 (0, 0, 1, 1))               # (B, D, D+2, N)
    lo, hi = gp[:, :, :-1], gp[:, :, 1:]                     # g[j'-1], g[j']
    gx = wx * lo + (1.0 - wx) * hi                           # (B, D, P, N)
    gxp = lo - hi
    gxz = torch.nn.functional.pad(gx, (0, 0, 0, 0, 1, 1))    # (B, D+2, P, N)
    dT = wy * gxz[:, :-1] + (1.0 - wy) * gxz[:, 1:]          # (B, P, P, N)
    dflat = torch.zeros((b, hl * wl, n), dtype=torch.float32,
                        device=corr_t.device)
    dflat.scatter_add_(1, idx, torch.where(ok, dT.reshape(b, -1, n), 0.0))
    w0 = torch.where(rowok[:, :d], 1.0 - wy[:, 0], 0.0)[:, :, None]
    w1 = torch.where(rowok[:, 1:], wy[:, 0], 0.0)[:, :, None]
    A = w0 * T[:, :d] + w1 * T[:, 1:]                        # (B, D, P, N)
    cm = colok[:, None]                                      # (B, 1, P, N)
    dcy = torch.where(cm, (T[:, 1:] - T[:, :d]) * gx, 0.0).sum(dim=(1, 2))
    dcx = torch.where(cm, A * gxp, 0.0).sum(dim=(1, 2))
    dcoords = torch.stack([dcx, dcy], dim=-1) / float(level_scale)
    return dflat.reshape(b, hl, wl, n).to(corr_t.dtype), dcoords




def _check(vols, coords: Tensor, what: str):
    """Raise unless ``vols`` are 1 to 4 contiguous (B, H0 >> l, W0 >> l, N)
    volumes of one dtype (f32 or bf16) and device, and ``coords`` is a
    contiguous f32 (B, N, 2) on that device. One pass a call, for the plain
    version and the kernels alike."""
    if not 1 <= len(vols) <= MAX_LEVELS:
        raise ValueError(f"{what}: {len(vols)} levels; 1 to {MAX_LEVELS}")
    first = vols[0]
    if first.ndim != 4:
        raise ValueError(f"{what}: level 0 is {tuple(first.shape)}; expected "
                         "(B, Hl, Wl, N)")
    b, h0, w0, n = first.shape
    if first.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: volume dtype {first.dtype}; float32 or bfloat16")
    if coords.shape != (b, n, 2):
        raise ValueError(f"{what}: coords {tuple(coords.shape)}; expected "
                         f"({b}, {n}, 2) for level 0 {tuple(first.shape)}")
    if coords.dtype != torch.float32:
        raise TypeError(f"{what}: coords {coords.dtype}; expected float32")
    if not coords.is_contiguous():
        raise ValueError(f"{what}: coords is not contiguous")
    if coords.device != first.device:
        raise ValueError(f"{what}: volume on {first.device}, coords on "
                         f"{coords.device}")
    for lvl, v in enumerate(vols):
        if v.shape != (b, h0 >> lvl, w0 >> lvl, n):
            raise ValueError(
                f"{what}: level {lvl} is {tuple(v.shape)}; expected "
                f"{(b, h0 >> lvl, w0 >> lvl, n)}, level 0's "
                f"{tuple(first.shape)} pooled by {2 ** lvl}")
        if v.dtype != first.dtype:
            raise TypeError(f"{what}: level {lvl} is {v.dtype}, level 0 "
                            f"{first.dtype}")
        if v.device != first.device:
            raise ValueError(f"{what}: level {lvl} on {v.device}, level 0 on "
                             f"{first.device}")
        if not v.is_contiguous():
            raise ValueError(f"{what}: level {lvl} is not contiguous")


def _kernel_args(vols, radius: int, level_scale: float, what: str):
    """What both C entries take after their pointers: B, N, H0, W0, L,
    radius, 1 / level 0's scale, dtype, stream."""
    if radius != RADIUS:
        raise ValueError(f"{what}: radius {radius} (the kernel takes {RADIUS})")
    b, h0, w0, n = vols[0].shape
    return (b, n, h0, w0, len(vols), radius, 1.0 / float(level_scale),
            1 if vols[0].dtype == torch.bfloat16 else 0,
            _build.stream_of(vols[0]))


def _level_ptrs(vols):
    return [v.data_ptr() for v in vols] + [None] * (MAX_LEVELS - len(vols))


def lanewise_fwd_pyramid(pyramid_t, coords: Tensor, radius: int = RADIUS,
                         level_scale: float = 1.0,
                         what: str = "lanewise_fwd_pyramid") -> Tensor:
    """K4 on CUDA tensors (one launch), the plain version level by level on
    CPU tensors.

    :param pyramid_t: 1 to 4 (B, Hl, Wl, N) volumes, level l the pooled half
        of level l - 1, read at ``coords / (level_scale * 2^l)``
    :param coords: (B, N, 2) f32 sample centres (x, y)
    :return: (B, L*D*D, N) f32, level l at channels D*D l .. D*D (l + 1) - 1
    """
    global launches
    vols = list(pyramid_t)
    _check(vols, coords, what)
    plain = plain_or_cuda(vols[0], what)
    b, _, _, n = vols[0].shape
    dd = (2 * radius + 1) ** 2
    out = torch.empty((b, len(vols) * dd, n), dtype=torch.float32,
                      device=coords.device)
    if plain:
        for lvl, (v, o) in enumerate(zip(vols, out.split(dd, dim=1))):
            o.copy_(lanewise_fwd_plain(v, coords, radius, level_scale * 2 ** lvl))
        return out
    args = _kernel_args(vols, radius, level_scale, what)
    fn = _build.function("corr_lanewise", "lanewise_fwd", _FWD_ARGTYPES)
    _build.check(fn(*_level_ptrs(vols), coords.data_ptr(), out.data_ptr(),
                    *args), what)
    launches += 1
    return out


def lanewise_bwd_pyramid(pyramid_t, coords: Tensor, g: Tensor,
                         radius: int = RADIUS, level_scale: float = 1.0,
                         what: str = "lanewise_bwd_pyramid"):
    """K5 on CUDA tensors (one launch, every element of every dcorr written
    by it), the plain version level by level on CPU tensors.

    :param g: (B, L*D*D, N) f32 cotangent of :func:`lanewise_fwd_pyramid`
    :return: the list of dcorr (B, Hl, Wl, N) in the volumes' dtype, and
        dcoords (B, N, 2) f32, the levels' summed in level order
    """
    global bwd_launches
    vols = list(pyramid_t)
    _check(vols, coords, what)
    plain = plain_or_cuda(vols[0], what)
    b, _, _, n = vols[0].shape
    dd = (2 * radius + 1) ** 2
    if (g.shape != (b, len(vols) * dd, n) or g.dtype != torch.float32
            or not g.is_contiguous() or g.device != coords.device):
        raise ValueError(f"{what}: cotangent {tuple(g.shape)} {g.dtype} on "
                         f"{g.device}; expected contiguous float32 "
                         f"{(b, len(vols) * dd, n)}")
    if plain:
        dcorrs, dcoords = [], None
        for lvl, (v, gl) in enumerate(zip(vols, g.split(dd, dim=1))):
            dc, dx = lanewise_bwd_plain(v, coords, gl, radius,
                                        level_scale * 2 ** lvl)
            dcorrs.append(dc)
            dcoords = dx if dcoords is None else dcoords + dx
        return dcorrs, dcoords
    args = _kernel_args(vols, radius, level_scale, what)
    dcorrs = [torch.empty_like(v) for v in vols]
    dcoords = torch.empty((b, n, 2), dtype=torch.float32, device=coords.device)
    fn = _build.function("corr_lanewise", "lanewise_bwd", _BWD_ARGTYPES)
    _build.check(fn(*_level_ptrs(vols), coords.data_ptr(), g.data_ptr(),
                    *_level_ptrs(dcorrs), dcoords.data_ptr(), *args), what)
    bwd_launches += 1
    return dcorrs, dcoords


def lanewise_fwd(corr_t: Tensor, coords: Tensor, radius: int,
                 level_scale: float) -> Tensor:
    """K4 for one level: (B, Hl, Wl, N), (B, N, 2) -> (B, D*D, N) f32."""
    return lanewise_fwd_pyramid([corr_t], coords, radius, level_scale,
                                "lanewise_fwd")


def lanewise_bwd(corr_t: Tensor, coords: Tensor, g: Tensor, radius: int,
                 level_scale: float):
    """K5 for one level: dcorr (B, Hl, Wl, N) and dcoords (B, N, 2)."""
    dcorrs, dcoords = lanewise_bwd_pyramid([corr_t], coords, g, radius,
                                           level_scale, "lanewise_bwd")
    return dcorrs[0], dcoords


class _LanewiseLookup(torch.autograd.Function):
    """K4 forward, K5 backward, one launch each for the whole pyramid; the
    volumes and the coords are saved (the volumes are built once per RAFT
    pass, outside the GRU iterations)."""

    @staticmethod
    def forward(ctx, coords, radius, level_scale, what, *pyramid_t):
        ctx.save_for_backward(coords, *pyramid_t)
        ctx.radius, ctx.level_scale, ctx.what = radius, level_scale, what
        return lanewise_fwd_pyramid(pyramid_t, coords, radius, level_scale, what)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        coords, *pyramid_t = ctx.saved_tensors
        dcorrs, dcoords = lanewise_bwd_pyramid(
            pyramid_t, coords, g.float().contiguous(), ctx.radius,
            ctx.level_scale, ctx.what)
        need = ctx.needs_input_grad
        return (dcoords if need[0] else None, None, None, None,
                *[d if k else None for d, k in zip(dcorrs, need[4:])])


def lanewise_lookup_level(corr_t: Tensor, coords: Tensor, radius: int = 4,
                          level_scale: float = 1.0) -> Tensor:
    """Bilinear window lookup for one pyramid level, differentiable with
    respect to the volume and the coords: the one-level case of
    :func:`lanewise_lookup`'s kernels.

    :param corr_t: (B, Hl, Wl, N) transposed volume, f32 or bf16
    :param coords: (B, N, 2) sample centres (x, y) in level-0 pixels
    :return: (B, D*D, N) f32, dy-major
    """
    return _LanewiseLookup.apply(coords.float().contiguous(), radius,
                                 float(level_scale), "lanewise_lookup_level",
                                 corr_t.contiguous())


def lanewise_lookup(pyramid_t, coords: Tensor, radius: int = 4):
    """Full-pyramid lookup, differentiable with respect to every level and
    the coords: one K4 launch forward, one K5 launch backward.

    :param pyramid_t: list of 1 to 4 (B, Hl, Wl, N) from
        ``build_corr_pyramid_t``: contiguous, one dtype and device
    :param coords: (B, H, W, 2) f32 correspondence estimates (x, y), 1/8-res
        px, N = H*W row-major
    :return: list of per-level (B, D*D, N) f32: views of one (B, L*D*D, N)
        buffer
    """
    what = "lanewise_lookup"
    if coords.ndim != 4 or coords.shape[3] != 2:
        raise ValueError(f"{what}: coords {tuple(coords.shape)}; expected "
                         "(B, H, W, 2)")
    if coords.dtype != torch.float32:
        raise TypeError(f"{what}: coords {coords.dtype}; expected float32")
    b, h, w, _ = coords.shape
    c = coords.reshape(b, h * w, 2).contiguous()
    pyramid_t = list(pyramid_t)
    _check(pyramid_t, c, what)
    out = _LanewiseLookup.apply(c, radius, 1.0, what, *pyramid_t)
    return list(out.split((2 * radius + 1) ** 2, dim=1))
