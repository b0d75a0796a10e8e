"""On-the-fly RAFT correlation window lookup (CUDA C++ kernel K1) and its
plain PyTorch version.

Replaces ``robust_pose_tpu/ops/pallas_corr_onthefly.py::_onthefly_kernel``
(``_lookup_level`` / ``onthefly_lookup``). The kernel source,
``csrc/corr_onthefly.cu``, states what bounds it and how it is built. The
all-pairs volume is never materialized: pyramid levels come from 2x2
mean-pooling the frame-2 *features* (``pool_fmap_pyramid``), which is exact
because the correlation is linear in f2.

Contract (the JAX package's): f1 (B, N, C) and the levels (B, H0 >> l,
W0 >> l, C) in one dtype, bf16 or f32; coords (B, N, 2) f32 (x, y) in level-0
pixels; a window radius r, 4 (RAFT large) or 3 (RAFT small); level l gives
(B, D*D, N) f32, D = 2r + 1, dy-major, each value
``<f2_l[y, x], f1[n]> / sqrt(C)`` bilinearly sampled with zero padding at
``coords / 2^l - r + (dy, dx)``.

One launch runs every level of a pyramid: :func:`pyramid_forward` fills one
(B, L*D*D, N) buffer, level l at rows D*D l .. D*D (l + 1) - 1, and the
entries hand out its per-level (B, D*D, N) views, the list RAFT's motion
encoder takes. The wrappers take the radii the kernel is built for
(``RADII``) on every device; the plain per-level function
(:func:`corr_lookup_level_plain`) takes any.
:func:`corr_lookup_level` is the one-level case of the same kernel.

Gradient: :func:`onthefly_lookup_pyramid` is one ``torch.autograd.Function``
over the pyramid, whose backward is autograd through the plain version
level by level, as the JAX package's custom VJP goes through
``_xla_reference_level``. That backward materializes the f32 (B, N, Hl, Wl)
correlation slab of each level, as the JAX one does.
"""
from __future__ import annotations

import ctypes
import math

import torch

from robust_pose_tpu_torch.device import plain_or_cuda
from robust_pose_tpu_torch.ops import _build
from robust_pose_tpu_torch.utils import costs

Tensor = torch.Tensor

RADIUS = 4          # RAFT large; RAFT small looks up radius 3
RADII = (3, 4)      # the radii the kernel is instantiated for
MAX_LEVELS = 4      # levels one launch takes (RAFT's pyramid has 4)

launches = 0        # K1 launches (one per call, whatever the levels)

# f1, the 4 level pointers, coords, out, B, N, C, Hq, Wq, TH, H0, W0, L,
# radius, 1 / level 0's scale, 1 / sqrt(C), dtype, stream
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
             + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def pool_fmap_pyramid(fmap2: Tensor, num_levels: int = 4):
    """2x2 mean-pool pyramid of frame-2 features (floor semantics).

    :param fmap2: (B, H, W, C) 1/8-res features
    :return: list of (B, Hl, Wl, C), level 0 = input
    """
    levels = [fmap2]
    for _ in range(num_levels - 1):
        prev = levels[-1]
        b, h, w, c = prev.shape
        p = prev[:, :(h // 2) * 2, :(w // 2) * 2]
        levels.append(p.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4)))
    return levels


def corr_lookup_level_plain(f1: Tensor, f2l: Tensor, coords: Tensor,
                            radius: int, level_scale: float) -> Tensor:
    """Plain version (the JAX package's ``_xla_reference_level``): the full
    f32 correlation slab, reduced with one-hot bilinear weight products.

    :param f1: (B, N, C); f2l: (B, Hl, Wl, C); coords: (B, N, 2) level-0 px
    :return: (B, (2r+1)^2, N) f32, dy-major
    """
    b, n, c = f1.shape
    _, hl, wl, _ = f2l.shape
    d = 2 * radius + 1
    corr = torch.einsum("bhwc,bnc->bnhw", f2l.float(), f1.float()) / math.sqrt(c)
    cs = coords.float() / level_scale
    cx, cy = cs[..., 0], cs[..., 1]
    x0 = torch.floor(cx)
    y0 = torch.floor(cy)
    wx = (cx - x0)[:, :, None, None]
    wy = (cy - y0)[:, :, None, None]
    dd = torch.arange(d, dtype=torch.float32, device=f1.device) - radius
    ys = (y0[:, :, None] + dd)[..., None]                 # (B, N, D, 1)
    xs = (x0[:, :, None] + dd)[..., None]
    ygrid = torch.arange(hl, dtype=torch.float32, device=f1.device)
    xgrid = torch.arange(wl, dtype=torch.float32, device=f1.device)
    Wy = (ygrid == ys) * (1.0 - wy) + (ygrid == ys + 1) * wy   # (B, N, D, Hl)
    Wx = (xgrid == xs) * (1.0 - wx) + (xgrid == xs + 1) * wx   # (B, N, D, Wl)
    A = torch.einsum("bnih,bnhw->bniw", Wy, corr)
    val = torch.einsum("bniw,bnjw->bnij", A, Wx)
    return val.reshape(b, n, d * d).transpose(1, 2).contiguous()


def _window_size(radius: int, what: str) -> int:
    """D = 2r + 1 for a radius the kernel takes; raise for another."""
    if radius not in RADII:
        raise ValueError(f"{what}: radius {radius}; the kernel takes {RADII}")
    return 2 * radius + 1


def _check(f1: Tensor, levels, coords: Tensor, grid, what: str):
    """Raise unless f1 is (B, N, C) f32 or bf16, the levels 1 to 4
    (B, H0 >> l, W0 >> l, C) in f1's dtype and on its device, coords a
    (B, N, 2) f32 on that device, and ``grid`` (H, W) with H W = N. One pass
    a call, for the plain version and the kernel alike."""
    if f1.ndim != 3:
        raise ValueError(f"{what}: f1 is {tuple(f1.shape)}; expected (B, N, C)")
    b, n, c = f1.shape
    if f1.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: f1 dtype {f1.dtype}; float32 or bfloat16")
    if coords.shape != (b, n, 2) or coords.dtype != torch.float32:
        raise ValueError(f"{what}: coords {tuple(coords.shape)} {coords.dtype}; "
                         f"expected float32 ({b}, {n}, 2)")
    if coords.device != f1.device:
        raise ValueError(f"{what}: f1 on {f1.device}, coords on {coords.device}")
    if grid[0] * grid[1] != n:
        raise ValueError(f"{what}: query grid {tuple(grid)} for N = {n}")
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"{what}: {len(levels)} levels; 1 to {MAX_LEVELS}")
    first = levels[0]
    if first.ndim != 4 or first.shape[0] != b or first.shape[3] != c:
        raise ValueError(f"{what}: level 0 is {tuple(first.shape)}; expected "
                         f"({b}, Hl, Wl, {c})")
    h0, w0 = first.shape[1:3]
    for lvl, v in enumerate(levels):
        if v.shape != (b, h0 >> lvl, w0 >> lvl, c):
            raise ValueError(
                f"{what}: level {lvl} is {tuple(v.shape)}; expected "
                f"{(b, h0 >> lvl, w0 >> lvl, c)}, level 0's "
                f"{tuple(first.shape)} pooled by {2 ** lvl}")
        if v.dtype != f1.dtype:
            raise TypeError(f"{what}: level {lvl} is {v.dtype}, f1 {f1.dtype}")
        if v.device != f1.device:
            raise ValueError(f"{what}: level {lvl} on {v.device}, f1 on "
                             f"{f1.device}")


def _launch(f1: Tensor, levels, coords: Tensor, out: Tensor, grid,
            radius: int, level_scale: float, what: str) -> None:
    """One K1 launch over all ``levels`` (checked CUDA tensors) into the
    (B, L*D*D, N) buffer ``out``; counts the launch."""
    global launches
    b, n, c = f1.shape
    bf16 = f1.dtype == torch.bfloat16
    if not (c in (128, 256) if bf16 else c % 128 == 0 and c <= 512):
        raise ValueError(f"{what}: C = {c}; the kernel takes "
                         + ("128 or 256" if bf16 else "a multiple of 128 up to 512")
                         + f" for {f1.dtype}")
    tensors = [f1, coords, *levels]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: inputs must be 16-byte aligned")
    hq, wq = grid
    th = min(8, 1 << (hq.bit_length() - 1))    # tile rows: 8, or fewer
    ptrs = [v.data_ptr() for v in levels] + [None] * (MAX_LEVELS - len(levels))
    h0, w0 = levels[0].shape[1:3]
    fn = _build.function("corr_onthefly", "corr_window_pyramid", _ARGTYPES)
    _build.check(fn(f1.data_ptr(), *ptrs, coords.data_ptr(), out.data_ptr(),
                    b, n, c, hq, wq, th, h0, w0, len(levels), radius,
                    1.0 / float(level_scale), 1.0 / math.sqrt(c),
                    1 if bf16 else 0, _build.stream_of(f1)), what)
    launches += 1


def pyramid_forward(f1: Tensor, levels, coords: Tensor, radius: int = RADIUS,
                    level_scale: float = 1.0, grid=None,
                    what: str = "pyramid_forward") -> Tensor:
    """K1 on CUDA tensors (one launch), the plain version level by level on
    CPU tensors; no gradient.

    :param f1: (B, N, C) query features, bf16 or f32
    :param levels: 1 to 4 (B, Hl, Wl, C) in f1's dtype, level l the pooled
        half of level l - 1, read at ``coords / (level_scale * 2^l)``
    :param coords: (B, N, 2) f32 sample centres (x, y)
    :param radius: window radius, 3 or 4
    :param grid: (H, W) of the queries, N = H W row-major (the kernel tiles
        them 8 x 8); default one row
    :return: (B, L*D*D, N) f32, D = 2 radius + 1, level l at rows D*D l ..
        D*D (l + 1) - 1
    """
    levels = list(levels)
    b, n = f1.shape[:2]
    grid = (1, n) if grid is None else tuple(grid)
    _check(f1, levels, coords, grid, what)
    d = _window_size(radius, what)
    out = torch.empty((b, len(levels) * d * d, n), dtype=torch.float32,
                      device=f1.device)
    if plain_or_cuda(f1, what):
        with costs.suspended():
            for lvl, (v, o) in enumerate(zip(levels, out.split(d * d, dim=1))):
                o.copy_(corr_lookup_level_plain(f1, v, coords, radius,
                                                level_scale * 2 ** lvl))
    else:
        _launch(f1, levels, coords, out, grid, radius, level_scale, what)
    if costs.active:
        costs.kernel("corr_window_lookup", costs.corr_window, f1, levels,
                     coords, radius, level_scale)
    return out


def corr_lookup_level(f1: Tensor, f2l: Tensor, coords: Tensor,
                      radius: int = RADIUS, level_scale: float = 1.0) -> Tensor:
    """One pyramid level of the window lookup, no gradient: the one-level
    case of :func:`pyramid_forward` (kernel on CUDA tensors, plain version
    on CPU tensors).

    :param f1: (B, N, C) query features, bf16 or f32
    :param f2l: (B, Hl, Wl, C) level features, same dtype
    :param coords: (B, N, 2) f32 correspondence estimates, level-0 pixels
    :return: (B, (2r+1)^2, N) f32, dy-major window order
    """
    return pyramid_forward(f1, [f2l], coords, radius, level_scale,
                           what="corr_lookup_level")


class _OntheflyLookup(torch.autograd.Function):
    """One K1 launch forward for the whole pyramid; backward: autograd
    through the plain version level by level (f1's, the levels' and the
    coords' cotangents; df1 and dcoords summed over the levels in level
    order, in f32)."""

    @staticmethod
    def forward(ctx, f1, coords, radius, level_scale, grid, *levels):
        ctx.save_for_backward(f1, coords, *levels)
        ctx.radius, ctx.level_scale = radius, level_scale
        return pyramid_forward(f1, levels, coords, radius, level_scale, grid,
                               "onthefly_lookup_pyramid")

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        f1, coords, *levels = ctx.saved_tensors
        f1g, cg = (t.detach().float().requires_grad_() for t in (f1, coords))
        df1 = dcoords = None
        dlevels = []
        dd = (2 * ctx.radius + 1) ** 2
        for lvl, (v, gl) in enumerate(zip(levels, g.float().split(dd, dim=1))):
            vg = v.detach().requires_grad_()
            with torch.enable_grad():
                out = corr_lookup_level_plain(f1g, vg, cg, ctx.radius,
                                              ctx.level_scale * 2 ** lvl)
            d1, dv, dc = torch.autograd.grad(out, (f1g, vg, cg), gl)
            df1 = d1 if df1 is None else df1 + d1
            dcoords = dc if dcoords is None else dcoords + dc
            dlevels.append(dv.to(v.dtype))
        return (df1.to(f1.dtype), dcoords, None, None, None, *dlevels)


def onthefly_lookup_pyramid(f1: Tensor, levels, coords: Tensor,
                            radius: int = RADIUS, level_scale: float = 1.0):
    """Full-pyramid window lookup, one K1 launch, differentiable with
    respect to f1, every level and the coords.

    :param f1: (B, H, W, C) frame-1 features (1/8 res), bf16 or f32
    :param levels: list of 1 to 4 (B, Hl, Wl, C) from ``pool_fmap_pyramid``
        in f1's dtype, level l read at ``coords / (level_scale * 2^l)``
    :param coords: (B, H, W, 2) correspondence estimates (x, y), 1/8-res px
    :param radius: window radius, 3 or 4
    :return: list of per-level (B, D*D, N) f32, D = 2 radius + 1, N = H*W
        row-major: views of one (B, L*D*D, N) buffer
    """
    what = "onthefly_lookup_pyramid"
    if f1.ndim != 4 or coords.shape != f1.shape[:3] + (2,):
        raise ValueError(f"{what}: f1 {tuple(f1.shape)}, coords "
                         f"{tuple(coords.shape)}; expected (B, H, W, C) and "
                         "(B, H, W, 2)")
    b, h, w, c = f1.shape
    f1f = f1.reshape(b, h * w, c)
    cs = coords.reshape(b, h * w, 2).float().contiguous()
    levels = [v.contiguous() for v in levels]
    d = _window_size(radius, what)
    out = _OntheflyLookup.apply(f1f.contiguous(), cs, radius, float(level_scale),
                                (h, w), *levels)
    return list(out.split(d * d, dim=1))


def onthefly_lookup(f1: Tensor, f2_levels, coords: Tensor, radius: int = RADIUS):
    """The JAX package's name and signature for
    :func:`onthefly_lookup_pyramid` (RAFT's ``lookup: onthefly``): one
    launch a 4-level lookup, one ``autograd.Function`` over the pyramid."""
    return onthefly_lookup_pyramid(f1, f2_levels, coords, radius)
