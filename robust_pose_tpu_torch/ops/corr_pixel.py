"""Per-query RAFT correlation lookup over the all-pairs volume: K7 (a block
per tile of 32 neighbouring queries) and K6 (a warp per query), both CUDA
C++, and their one plain PyTorch version (the two kernels compute the same
function). One launch runs every level of a pyramid.

Replaces ``robust_pose_tpu/ops/pallas_lookup.py``: ``_lookup_kernel``
(reached through ``pallas_lookup_level`` / ``pallas_lookup_pyramid``) and
``_lookup_kernel_grouped`` (``pallas_lookup_level_grouped`` /
``pallas_lookup_pyramid_grouped``, RAFT's ``lookup: grouped``). Both are
bound by bytes (the taps read and, twice as many, the f32 outputs written)
and, at the f2m step's batch of 1, by the launch itself. K7 loads a tile's
taps cooperatively into shared memory and stores full 128-byte lines of the
(B, L*81, N) layout; K6 coalesces in the level functions' (M, 81) layout.
The kernel source, ``csrc/corr_pixel.cu``, has the designs in full.

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
(M, 81): the one-level case of the same kernels. The pyramid functions take
RAFT's (B, N, Hl, Wl) levels, each the pooled half of the one before
(``build_corr_pyramid``), and (B, H, W, 2) centres in level-0 pixels. They
fill one (B, L*81, N) f32 buffer and return its per-level (B, 81, N) views,
the list that RAFT's motion encoder takes, so nothing is transposed or
concatenated. The lookup has no gradient (the JAX ``pallas_call`` has no
VJP either).
"""
from __future__ import annotations

import ctypes

import torch

from robust_pose_tpu_torch.device import plain_or_cuda
from robust_pose_tpu_torch.ops import _build

Tensor = torch.Tensor

RADIUS = 4
D = 2 * RADIUS + 1

MAX_LEVELS = 4         # levels one launch takes (RAFT's pyramid has 4)

launches = 0           # K6 launches (one per call, whatever the levels)
grouped_launches = 0   # K7 launches

# the 4 level pointers, coords, out, B, N, H0, W0, L, out strides (batch,
# level, window entry, query), dtype, stream
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_void_p])


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


def _check(vols, lead, coords: Tensor, what: str):
    """Raise unless ``vols`` are contiguous ``lead + (H0 >> l, W0 >> l)``
    volumes of one dtype (f32 or bf16) on the device of the contiguous f32
    ``coords`` (2 values a query). One pass a call, for the plain version
    and the kernels alike."""
    if not 1 <= len(vols) <= MAX_LEVELS:
        raise ValueError(f"{what}: {len(vols)} levels; 1 to {MAX_LEVELS}")
    first = vols[0]
    if first.ndim != len(lead) + 2 or first.shape[:-2] != lead:
        raise ValueError(f"{what}: level 0 is {tuple(first.shape)}; expected "
                         f"{lead + ('Hl', 'Wl')}")
    h0, w0 = first.shape[-2:]
    if first.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: volume dtype {first.dtype}; float32 or bfloat16")
    if coords.dtype != torch.float32 or not coords.is_contiguous():
        raise ValueError(f"{what}: coords {coords.dtype}, contiguous "
                         f"{coords.is_contiguous()}; expected contiguous float32")
    if coords.device != first.device:
        raise ValueError(f"{what}: volume on {first.device}, coords on "
                         f"{coords.device}")
    for lvl, v in enumerate(vols):
        if v.shape != lead + (h0 >> lvl, w0 >> lvl):
            raise ValueError(
                f"{what}: level {lvl} is {tuple(v.shape)}; expected "
                f"{lead + (h0 >> lvl, w0 >> lvl)}, level 0's "
                f"{tuple(first.shape)} pooled by {2 ** lvl}")
        if v.dtype != first.dtype:
            raise TypeError(f"{what}: level {lvl} is {v.dtype}, level 0 "
                            f"{first.dtype}")
        if v.device != first.device:
            raise ValueError(f"{what}: level {lvl} on {v.device}, level 0 on "
                             f"{first.device}")
        if not v.is_contiguous():
            raise ValueError(f"{what}: level {lvl} is not contiguous")


def _launch(vols, coords: Tensor, out: Tensor, b: int, n: int, strides,
            grouped: bool):
    """Run K6 (``grouped`` False) or K7 once over all levels ``vols``
    (checked CUDA tensors) and count the launch; query b N + q of level l
    writes out[b sb + l sl + e sk + q sq] for (sb, sl, sk, sq) =
    ``strides``."""
    global launches, grouped_launches
    what = "grouped_lookup" if grouped else "pixel_lookup"
    ptrs = [v.data_ptr() for v in vols] + [None] * (MAX_LEVELS - len(vols))
    h0, w0 = vols[0].shape[-2:]
    fn = _build.function("corr_pixel", what, _ARGTYPES)
    _build.check(fn(*ptrs, coords.data_ptr(), out.data_ptr(), b, n, h0, w0,
                    len(vols), *strides,
                    1 if vols[0].dtype == torch.bfloat16 else 0,
                    _build.stream_of(out)), what)
    if grouped:
        grouped_launches += 1
    else:
        launches += 1


def _level(corr: Tensor, coords: Tensor, grouped: bool) -> Tensor:
    what = "grouped_lookup_level" if grouped else "pixel_lookup_level"
    m = corr.shape[0]
    if coords.shape != (m, 2):
        raise ValueError(f"{what}: coords {tuple(coords.shape)}; expected ({m}, 2)")
    _check([corr], (m,), coords, what)
    if plain_or_cuda(corr, what):
        return pixel_lookup_level_plain(corr, coords)
    out = torch.empty((m, D * D), dtype=torch.float32, device=corr.device)
    _launch([corr], coords, out, 1, m, (0, 0, 1, D * D), grouped)
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
    if coords.ndim != 4 or coords.shape[3] != 2:
        raise ValueError(f"{what}: coords {tuple(coords.shape)}; expected "
                         "(B, H, W, 2)")
    b, h, w, _ = coords.shape
    n = h * w
    if torch.is_grad_enabled() and (coords.requires_grad
                                    or any(v.requires_grad for v in pyramid)):
        raise RuntimeError(
            f"{what} has no gradient (nor has the JAX package's Pallas "
            "lookup): train RAFT through lookup='lanewise', or set "
            "train.stop_flow_grad")
    if coords.dtype != torch.float32 or not coords.is_contiguous():
        coords = coords.float().contiguous()
    _check(pyramid, (b, n), coords, what)
    nl = len(pyramid)
    out = torch.empty((b, nl * D * D, n), dtype=torch.float32,
                      device=coords.device)
    outs = out.split(D * D, dim=1)
    if plain_or_cuda(coords, what):
        c = coords.view(b * n, 2)
        for lvl, (vol, o) in enumerate(zip(pyramid, outs)):
            v = pixel_lookup_level_plain(vol.view(b * n, *vol.shape[2:]),
                                         c / float(2 ** lvl))
            o.copy_(v.view(b, n, D * D).transpose(1, 2))
    else:
        _launch(pyramid, coords, out, b, n,
                (nl * D * D * n, D * D * n, n, 1), grouped)
    return list(outs)


def pixel_lookup_pyramid(pyramid, coords: Tensor):
    """Full-pyramid lookup through K6, one launch.

    :param pyramid: list of 1 to 4 (B, N, Hl, Wl) volumes, level l the
        pooled half of level l - 1 (``build_corr_pyramid``)
    :param coords: (B, H, W, 2) centres (x, y) in level-0 pixels, N = H W
    :return: list of per-level (B, 81, N) f32, dy-major: views of one
        (B, L*81, N) buffer
    """
    return _pyramid(pyramid, coords, grouped=False)


def grouped_lookup_pyramid(pyramid, coords: Tensor):
    """Full-pyramid lookup through K7 (RAFT's ``lookup: grouped``), one
    launch; the contract of :func:`pixel_lookup_pyramid`."""
    return _pyramid(pyramid, coords, grouped=True)


def noop_launch(like: Tensor) -> None:
    """Launch an empty kernel on the current stream of ``like``'s device
    through the same ctypes path: what any launch costs at least, for
    measurements."""
    if plain_or_cuda(like, "noop_launch"):
        raise RuntimeError("noop_launch: a CUDA tensor is needed")
    fn = _build.function("corr_pixel", "noop_launch", [ctypes.c_void_p])
    _build.check(fn(_build.stream_of(like)), "noop_launch")
