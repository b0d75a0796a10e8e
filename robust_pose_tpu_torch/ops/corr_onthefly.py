"""On-the-fly RAFT correlation window lookup (CUDA C++ kernel) and its
plain PyTorch version.

Replaces ``robust_pose_tpu/ops/pallas_corr_onthefly.py::_onthefly_kernel``
(``_lookup_level`` / ``onthefly_lookup``). The kernel source,
``csrc/corr_onthefly.cu``, states what bounds it and how it is built. The
all-pairs volume is never materialized: pyramid levels come from 2x2
mean-pooling the frame-2 *features* (``pool_fmap_pyramid``), which is exact
because the correlation is linear in f2.

Gradient: each level is a ``torch.autograd.Function`` whose backward is
autograd through the plain version, as the JAX package's custom VJP goes
through ``_xla_reference_level``. That backward materializes the f32
(B, N, Hl, Wl) correlation slab of the level, as the JAX one does.
"""
from __future__ import annotations

import ctypes
import math

import torch

from robust_pose_tpu_torch.device import plain_or_cuda
from robust_pose_tpu_torch.ops import _build

Tensor = torch.Tensor

launches = 0  # kernel launches (one per pyramid level and call)

# f1, f2, coords, out, B, N, C, Hl, Wl, radius, inv_scale, inv_sqrt_c,
# dtype, stream
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
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


def corr_lookup_level(f1: Tensor, f2l: Tensor, coords: Tensor,
                      radius: int = 4, level_scale: float = 1.0) -> Tensor:
    """One pyramid level of the window lookup; kernel on CUDA tensors,
    plain version on CPU tensors.

    :param f1: (B, N, C) query features, bf16 or f32
    :param f2l: (B, Hl, Wl, C) level features, same dtype
    :param coords: (B, N, 2) f32 correspondence estimates, level-0 pixels
    :return: (B, (2r+1)^2, N) f32, dy-major window order
    """
    global launches
    if plain_or_cuda(f1, "corr_lookup_level"):
        return corr_lookup_level_plain(f1, f2l, coords, radius, level_scale)
    b, n, c = f1.shape
    _, hl, wl, c2 = f2l.shape
    if c2 != c or f2l.shape[0] != b or coords.shape != (b, n, 2):
        raise ValueError(f"corr_lookup_level: shapes {tuple(f1.shape)}, "
                         f"{tuple(f2l.shape)}, {tuple(coords.shape)}")
    if f1.dtype != f2l.dtype or f1.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"corr_lookup_level: dtypes {f1.dtype}, {f2l.dtype}")
    if c % 8 or coords.dtype != torch.float32:
        raise ValueError("corr_lookup_level: C must be a multiple of 8 and "
                         "coords f32")
    if not (f1.is_contiguous() and f2l.is_contiguous() and coords.is_contiguous()):
        raise ValueError("corr_lookup_level: inputs must be contiguous")
    if f1.data_ptr() % 16 or f2l.data_ptr() % 16:
        raise ValueError("corr_lookup_level: inputs must be 16-byte aligned")
    d = 2 * radius + 1
    out = torch.empty((b, d * d, n), dtype=torch.float32, device=f1.device)
    fn = _build.function("corr_onthefly", "corr_window_level", _ARGTYPES)
    _build.check(fn(_build.ptr(f1), _build.ptr(f2l), _build.ptr(coords),
                    _build.ptr(out), b, n, c, hl, wl, radius,
                    1.0 / float(level_scale), 1.0 / math.sqrt(c),
                    1 if f1.dtype == torch.bfloat16 else 0,
                    _build.stream_of(f1)), "corr_window_level")
    launches += 1
    return out


class _OntheflyLevel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f1, f2l, coords, radius, level_scale):
        ctx.save_for_backward(f1, f2l, coords)
        ctx.radius, ctx.level_scale = radius, level_scale
        return corr_lookup_level(f1, f2l, coords, radius, level_scale)

    @staticmethod
    def backward(ctx, g):
        f1, f2l, coords = ctx.saved_tensors
        inputs = [t.detach().requires_grad_() for t in (f1, f2l, coords)]
        with torch.enable_grad():
            out = corr_lookup_level_plain(*inputs, ctx.radius, ctx.level_scale)
        grads = torch.autograd.grad(out, inputs, g.float())
        return tuple(d.to(t.dtype) for d, t in zip(grads, inputs)) + (None, None)


def onthefly_lookup(f1: Tensor, f2_levels, coords: Tensor, radius: int = 4):
    """Full-pyramid window lookup.

    :param f1: (B, H, W, C) frame-1 features (1/8 res)
    :param f2_levels: list of (B, Hl, Wl, C) from ``pool_fmap_pyramid``
    :param coords: (B, H, W, 2) correspondence estimates (x, y), 1/8-res px
    :return: list of per-level (B, (2r+1)^2, N) f32, N = H*W row-major
    """
    b, h, w, c = f1.shape
    f1f = f1.reshape(b, h * w, c)
    cs = coords.reshape(b, h * w, 2).float().contiguous()
    return [_OntheflyLevel.apply(f1f, f2l.contiguous(), cs, radius,
                                 float(2 ** lvl))
            for lvl, f2l in enumerate(f2_levels)]
