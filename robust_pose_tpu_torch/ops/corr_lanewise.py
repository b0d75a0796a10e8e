"""Lane-wise RAFT correlation lookup over the transposed volume: the
forward kernel (K4) and its backward kernel (K5), both CUDA C++, in one
``torch.autograd.Function`` per pyramid level, with the plain PyTorch
version of each.

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

launches = 0       # K4 launches (one per pyramid level and call)
bwd_launches = 0   # K5 launches

# corr, coords, out, B, N, Hl, Wl, radius, inv_scale, dtype, stream
_FWD_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# corr, coords, g, dcorr, dcoords, B, N, Hl, Wl, radius, inv_scale, dtype,
# stream
_BWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
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


def _check(corr_t: Tensor, coords: Tensor, radius: int, what: str):
    b, hl, wl, n = corr_t.shape
    if coords.shape != (b, n, 2) or coords.dtype != torch.float32:
        raise ValueError(f"{what}: coords {tuple(coords.shape)} "
                         f"{coords.dtype}, expected ({b}, {n}, 2) f32")
    if corr_t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: volume dtype {corr_t.dtype}")
    if radius != 4:
        raise ValueError(f"{what}: radius {radius} (the kernel takes 4)")
    if not (corr_t.is_contiguous() and coords.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous")
    if corr_t.device != coords.device:
        raise ValueError(f"{what}: inputs on {corr_t.device} and {coords.device}")


def lanewise_fwd(corr_t: Tensor, coords: Tensor, radius: int,
                 level_scale: float) -> Tensor:
    """K4 on CUDA tensors, the plain version on CPU tensors."""
    global launches
    if plain_or_cuda(corr_t, "lanewise_fwd"):
        return lanewise_fwd_plain(corr_t, coords, radius, level_scale)
    _check(corr_t, coords, radius, "lanewise_fwd")
    b, hl, wl, n = corr_t.shape
    d = 2 * radius + 1
    out = torch.empty((b, d * d, n), dtype=torch.float32, device=corr_t.device)
    fn = _build.function("corr_lanewise", "lanewise_fwd", _FWD_ARGTYPES)
    _build.check(fn(_build.ptr(corr_t), _build.ptr(coords), _build.ptr(out),
                    b, n, hl, wl, radius, 1.0 / float(level_scale),
                    1 if corr_t.dtype == torch.bfloat16 else 0,
                    _build.stream_of(corr_t)), "lanewise_fwd")
    launches += 1
    return out


def lanewise_bwd(corr_t: Tensor, coords: Tensor, g: Tensor, radius: int,
                 level_scale: float):
    """K5 on CUDA tensors, the plain version on CPU tensors."""
    global bwd_launches
    if plain_or_cuda(corr_t, "lanewise_bwd"):
        return lanewise_bwd_plain(corr_t, coords, g, radius, level_scale)
    _check(corr_t, coords, radius, "lanewise_bwd")
    b, hl, wl, n = corr_t.shape
    d = 2 * radius + 1
    if (g.shape != (b, d * d, n) or g.dtype != torch.float32
            or not g.is_contiguous()):
        raise ValueError(f"lanewise_bwd: cotangent {tuple(g.shape)} {g.dtype}")
    dcorr = torch.empty_like(corr_t)
    dcoords = torch.empty((b, n, 2), dtype=torch.float32, device=corr_t.device)
    fn = _build.function("corr_lanewise", "lanewise_bwd", _BWD_ARGTYPES)
    _build.check(fn(_build.ptr(corr_t), _build.ptr(coords), _build.ptr(g),
                    _build.ptr(dcorr), _build.ptr(dcoords), b, n, hl, wl,
                    radius, 1.0 / float(level_scale),
                    1 if corr_t.dtype == torch.bfloat16 else 0,
                    _build.stream_of(corr_t)), "lanewise_bwd")
    bwd_launches += 1
    return dcorr, dcoords


class _LanewiseLevel(torch.autograd.Function):
    """K4 forward, K5 backward; the volume and the coords are saved (the
    volume is built once per RAFT pass, outside the GRU iterations)."""

    @staticmethod
    def forward(ctx, corr_t, coords, radius, level_scale):
        coords = coords.float().contiguous()
        ctx.save_for_backward(corr_t, coords)
        ctx.radius, ctx.level_scale = radius, level_scale
        return lanewise_fwd(corr_t, coords, radius, level_scale)

    @staticmethod
    def backward(ctx, g):
        corr_t, coords = ctx.saved_tensors
        dcorr, dcoords = lanewise_bwd(corr_t, coords, g.float().contiguous(),
                                      ctx.radius, ctx.level_scale)
        return (dcorr if ctx.needs_input_grad[0] else None,
                dcoords if ctx.needs_input_grad[1] else None, None, None)


def lanewise_lookup_level(corr_t: Tensor, coords: Tensor, radius: int = 4,
                          level_scale: float = 1.0) -> Tensor:
    """Bilinear window lookup for one pyramid level, differentiable with
    respect to the volume and the coords.

    :param corr_t: (B, Hl, Wl, N) transposed volume, f32 or bf16
    :param coords: (B, N, 2) sample centres (x, y) in level-0 pixels
    :return: (B, D*D, N) f32, dy-major
    """
    return _LanewiseLevel.apply(corr_t.contiguous(), coords, radius,
                                float(level_scale))


def lanewise_lookup(pyramid_t, coords: Tensor, radius: int = 4):
    """Full-pyramid lookup.

    :param pyramid_t: list of (B, Hl, Wl, N) from ``build_corr_pyramid_t``
    :param coords: (B, H, W, 2) correspondence estimates (x, y), 1/8-res px
    :return: list of per-level (B, D*D, N) f32 (N = H*W row-major)
    """
    b, h, w, _ = coords.shape
    c = coords.reshape(b, h * w, 2)
    return [lanewise_lookup_level(corr_t, c, radius, float(2 ** lvl))
            for lvl, corr_t in enumerate(pyramid_t)]
