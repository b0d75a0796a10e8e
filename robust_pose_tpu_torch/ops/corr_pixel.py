"""Per-query RAFT correlation lookup over the all-pairs volume: K6 (one
thread per query) and K7 (a warp per 8 queries), both CUDA C++, and their
one plain PyTorch version (the two kernels compute the same function).

Replaces ``robust_pose_tpu/ops/pallas_lookup.py``: ``_lookup_kernel``
(reached through ``pallas_lookup_level`` / ``pallas_lookup_pyramid``) and
``_lookup_kernel_grouped`` (``pallas_lookup_level_grouped`` /
``pallas_lookup_pyramid_grouped``, RAFT's ``lookup: grouped``). The kernel
source, ``csrc/corr_pixel.cu``, states what bounds each kernel and how the
design answers it.

Contract (the JAX package's): each query m has its own correlation image
``corr[m]`` (Hl, Wl), f32 or bf16, and a centre (x, y) in the level's
pixels. With x0 = floor(x), wx = x - x0 and x0i = int(x0) - 4 (likewise y),

    ry[i, x] = (1 - wy) img[y0i + i, x] + wy img[y0i + i + 1, x]
    out[i, k] = (1 - wx) ry[i, x0i + k] + wx ry[i, x0i + k + 1]

for i, k in 0..8 (radius 4, fixed), the bf16 volume widened to f32 before
any product, and a tap row or column outside the level contributing
exactly zero (no clamping). The output is f32, dy-major. This is not the
``"xla"`` lookup (``models.raft.lookup_corr``), which casts the weights to
the volume's dtype.

The level functions take the JAX contract, (M, Hl, Wl) and (M, 2) ->
(M, 81); the pyramid functions take RAFT's (B, N, Hl, Wl) levels and
(B, H, W, 2) centres in level-0 pixels and return the port's lookup layout,
a list of (B, 81, N) per level, which the kernels write directly. The
lookup has no gradient (the JAX ``pallas_call`` has no VJP either).
"""
from __future__ import annotations

import ctypes

import torch

from robust_pose_tpu_torch.device import plain_or_cuda
from robust_pose_tpu_torch.ops import _build

Tensor = torch.Tensor

RADIUS = 4
D = 2 * RADIUS + 1

launches = 0           # K6 launches (one per level and call)
grouped_launches = 0   # K7 launches

# corr, coords, out, M, N, Hl, Wl, inv_scale, out strides (batch, k, query),
# dtype, stream
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float]
             + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p])


def pixel_lookup_level_plain(corr: Tensor, coords: Tensor) -> Tensor:
    """Plain K6/K7: (M, Hl, Wl) volume, (M, 2) centres in level pixels ->
    (M, 81) f32. Gathers the 10 x 10 taps of each window, then rows first
    and columns second, each a pair of products and one sum, as the
    contract states."""
    m, hl, wl = corr.shape
    c = coords.float()
    x0, y0 = torch.floor(c[:, 0]), torch.floor(c[:, 1])
    wx, wy = (c[:, 0] - x0)[:, None, None], (c[:, 1] - y0)[:, None]
    off = torch.arange(D + 1, dtype=torch.float32, device=corr.device) - RADIUS
    ys, xs = y0[:, None] + off, x0[:, None] + off              # (M, 10)
    rowok = (ys >= 0) & (ys < hl)
    colok = (xs >= 0) & (xs < wl)
    iy = torch.where(rowok, ys, 0.0).long()
    ix = torch.where(colok, xs, 0.0).long()
    idx = (iy[:, :, None] * wl + ix[:, None, :]).reshape(m, -1)
    taps = torch.gather(corr.reshape(m, hl * wl), 1, idx).float()
    taps = torch.where((rowok[:, :, None] & colok[:, None, :]).reshape(m, -1),
                       taps, 0.0).reshape(m, D + 1, D + 1)
    w0 = torch.where(rowok[:, :D], 1.0 - wy, 0.0)[..., None]    # (M, 9, 1)
    w1 = torch.where(rowok[:, 1:], wy, 0.0)[..., None]
    ry = w0 * taps[:, :D] + w1 * taps[:, 1:]                    # (M, 9, 10)
    out = (1.0 - wx) * ry[:, :, :D] + wx * ry[:, :, 1:]         # (M, 9, 9)
    return out.reshape(m, D * D)


def _check(corr: Tensor, coords: Tensor, what: str):
    m = corr.shape[0]
    if corr.ndim != 3 or coords.shape != (m, 2) or coords.dtype != torch.float32:
        raise ValueError(f"{what}: volume {tuple(corr.shape)}, coords "
                         f"{tuple(coords.shape)} {coords.dtype}; expected "
                         f"(M, Hl, Wl) and ({m}, 2) f32")
    if corr.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: volume dtype {corr.dtype}")
    if not (corr.is_contiguous() and coords.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous")
    if corr.device != coords.device:
        raise ValueError(f"{what}: inputs on {corr.device} and {coords.device}")


def _launch(corr: Tensor, coords: Tensor, inv_scale: float, out: Tensor,
            n: int, strides, grouped: bool):
    """Run K6 (``grouped`` False) or K7 on CUDA tensors and count the
    launch; query m = b N + q writes out[b sb + k sk + q sq] for
    (sb, sk, sq) = ``strides``."""
    global launches, grouped_launches
    what = "grouped_lookup" if grouped else "pixel_lookup"
    _check(corr, coords, what)
    m, hl, wl = corr.shape
    fn = _build.function("corr_pixel", what, _ARGTYPES)
    _build.check(fn(_build.ptr(corr), _build.ptr(coords), _build.ptr(out),
                    m, n, hl, wl, float(inv_scale), *strides,
                    1 if corr.dtype == torch.bfloat16 else 0,
                    _build.stream_of(corr)), what)
    if grouped:
        grouped_launches += 1
    else:
        launches += 1


def _level(corr: Tensor, coords: Tensor, grouped: bool) -> Tensor:
    what = "grouped_lookup_level" if grouped else "pixel_lookup_level"
    if plain_or_cuda(corr, what):
        return pixel_lookup_level_plain(corr, coords)
    m = corr.shape[0]
    out = torch.empty((m, D * D), dtype=torch.float32, device=corr.device)
    _launch(corr, coords, 1.0, out, m, (0, 1, D * D), grouped)
    return out


def pixel_lookup_level(corr: Tensor, coords: Tensor) -> Tensor:
    """K6 on CUDA tensors, the plain version on CPU tensors.

    :param corr: (M, Hl, Wl) per-query correlation images, f32 or bf16
    :param coords: (M, 2) f32 centres (x, y) in this level's pixels
    :return: (M, 81) f32 window values, dy-major
    """
    return _level(corr, coords, grouped=False)


def grouped_lookup_level(corr: Tensor, coords: Tensor) -> Tensor:
    """K7 on CUDA tensors, the plain version on CPU tensors (the contract of
    :func:`pixel_lookup_level`)."""
    return _level(corr, coords, grouped=True)


def _pyramid(pyramid, coords: Tensor, grouped: bool):
    what = "grouped_lookup_pyramid" if grouped else "pixel_lookup_pyramid"
    b, h, w, _ = coords.shape
    n = h * w
    c = coords.reshape(b * n, 2).float().contiguous()
    if torch.is_grad_enabled() and (coords.requires_grad
                                    or any(v.requires_grad for v in pyramid)):
        raise RuntimeError(
            f"{what} has no gradient (nor has the JAX package's Pallas "
            "lookup): train RAFT through lookup='lanewise', or set "
            "train.stop_flow_grad")
    outs = []
    for lvl, corr in enumerate(pyramid):
        _, _, hl, wl = corr.shape
        vol = corr.reshape(b * n, hl, wl)
        if plain_or_cuda(vol, what):
            v = pixel_lookup_level_plain(vol, c / float(2 ** lvl))
            outs.append(v.reshape(b, n, D * D).transpose(1, 2).contiguous())
            continue
        out = torch.empty((b, D * D, n), dtype=torch.float32, device=vol.device)
        _launch(vol.contiguous(), c, 1.0 / 2 ** lvl, out, n,
                (D * D * n, n, 1), grouped)
        outs.append(out)
    return outs


def pixel_lookup_pyramid(pyramid, coords: Tensor):
    """Full-pyramid lookup through K6.

    :param pyramid: list of (B, N, Hl, Wl) volumes (``build_corr_pyramid``)
    :param coords: (B, H, W, 2) centres (x, y) in level-0 pixels, N = H W
    :return: list of per-level (B, 81, N) f32, dy-major
    """
    return _pyramid(pyramid, coords, grouped=False)


def grouped_lookup_pyramid(pyramid, coords: Tensor):
    """Full-pyramid lookup through K7 (RAFT's ``lookup: grouped``); the
    contract of :func:`pixel_lookup_pyramid`."""
    return _pyramid(pyramid, coords, grouped=True)
