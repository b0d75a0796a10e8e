"""Instance norm over NHWC maps: K2's statistics and the whole norm, each
one call into ``csrc/instance_norm.cu`` (CUDA C++), with their plain
PyTorch versions.

Replaces ``robust_pose_tpu/ops/pallas_instance_norm.py::_stats_kernel``
(reached through ``instance_norm_stats``): per-(sample, channel) sum and
sum of squares over H x W as f32, for C <= 128 (the kernel sums in f64 and
rounds once, so that the card's norm follows the CPU's plain version as
closely as sums can: see the kernel source). The JAX
package leaves the normalize after it to XLA, which fuses it with the ReLU
that follows; on the card nothing fuses them, so :func:`instance_norm`
launches ``instance_norm_fwd``: the statistics, then one pass that writes
``[relu]((x - mu) * rstd)``. Each of the 15 norms of an fnet pass is one
call (three launches inside it). The kernel source has the design.

What bounds it on an H100: device-memory bytes (the norm reads x twice and
writes y once: 6 bytes an element in bf16 against a 4-byte floor, ~0.75 ms
of an f2f window's fnet pass at 3.35 TB/s).

Layout the kernels take: x (B, H, W, C) contiguous NHWC -- the NHWC view
(``permute(0, 2, 3, 1)``) of a ``channels_last`` NCHW tensor, which is how
the RAFT encoders keep their activations. The wrappers check it.

Gradients: ``instance_norm_stats`` is a ``torch.autograd.Function`` on both
devices with the JAX package's custom VJP as its backward, ``dx = gs + 2 x
gss``. ``instance_norm``'s backward recomputes the plain composition from
the saved x with the statistics through ``instance_norm_stats`` (the
statistics kernel on the card) and differentiates it, so its gradient is
the unfused norm's (the JAX package leaves this backward to XLA too).
"""
from __future__ import annotations

import ctypes

import torch

from robust_pose_tpu_torch.device import plain_or_cuda
from robust_pose_tpu_torch.ops import _build
from robust_pose_tpu_torch.utils import costs

Tensor = torch.Tensor

launches = 0          # instance_norm_fwd launches: one per norm
stats_launches = 0    # instance_norm_stats launches
MAX_C = 128           # the kernels' channel limit (the TPU kernel's lane width)
EPS = 1e-5

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_BLOCKS_PER_SM = 8    # 256-thread blocks an SM holds at full occupancy
_MIN_ROWS = 64        # rows a block takes at least
# x, part, out, B, HW, C, rows_per, nsplit, dtype, stream
_STATS_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
# x, y, part, mu, rstd, B, HW, C, rows_per, nsplit, eps, relu, dtype, stream
_FWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_n_sm: dict = {}


def instance_norm_stats_plain(x: Tensor):
    """Plain version: (sum, sum of squares) over H, W in f32, (B, C) each."""
    xf = x.float()
    return xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2))


def _moments(x: Tensor, s: Tensor, ss: Tensor, eps: float):
    """(mu, rstd), (B, C) f32 each, from the statistics of x, the JAX
    package's formula: var = max(E[x^2] - E[x]^2, 0), rstd = rsqrt(var +
    eps)."""
    cnt = float(x.shape[1] * x.shape[2])
    mu = s / cnt
    return mu, torch.rsqrt(torch.clamp(ss / cnt - mu * mu, min=0.0) + eps)


def _normalize(x: Tensor, s: Tensor, ss: Tensor, eps: float, relu: bool):
    """The norm from the statistics: (x - mu) rstd cast back to x's dtype,
    then the ReLU where asked."""
    mu, rstd = _moments(x, s, ss, eps)
    y = ((x.float() - mu[:, None, None, :]) * rstd[:, None, None, :]).to(x.dtype)
    return torch.relu(y) if relu else y


def instance_norm_plain(x: Tensor, eps: float = EPS, relu: bool = False):
    """Plain version of :func:`instance_norm` (any device): the statistics'
    plain version, the normalize, and ``relu`` (a clamp at 0 with the
    ReLU's gradient) as separate PyTorch ops."""
    return _normalize(x, *instance_norm_stats_plain(x), eps, relu)


def _plain(x: Tensor, what: str) -> bool:
    """True for a CPU tensor (the plain version), False for a CUDA one (the
    kernel); raises past C = 128 and on any other device."""
    if x.shape[-1] > MAX_C:
        raise ValueError(f"{what}: C = {x.shape[-1]} > {MAX_C}")
    return plain_or_cuda(x, what)


def _grid(x: Tensor, what: str):
    """(rows_per, nsplit) of a tensor the kernels take: each sample's H*W
    rows cut into nsplit chunks of rows_per (the last one shorter), enough
    blocks to fill every SM. Raises on what the kernels do not take."""
    b, h, w, _ = x.shape
    hw = h * w
    if not x.is_contiguous():
        raise ValueError(f"{what}: the kernel takes a contiguous NHWC tensor "
                         "(the NHWC view of a channels_last one)")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {x.dtype}")
    if not 0 < b <= 65535 or hw == 0:
        raise ValueError(f"{what}: input {tuple(x.shape)}; the kernels take 1 "
                         "to 65535 samples of at least one pixel")
    idx = x.device.index
    if idx not in _n_sm:
        _n_sm[idx] = torch.cuda.get_device_properties(x.device).multi_processor_count
    nsplit = max(1, min(-(-_BLOCKS_PER_SM * _n_sm[idx] // b), -(-hw // _MIN_ROWS)))
    rows_per = -(-hw // nsplit)
    return rows_per, -(-hw // rows_per)


def _launch_stats(x: Tensor):
    """The statistics entry on a checked CUDA tensor; counts the launch."""
    global stats_launches
    b, h, w, c = x.shape
    rows_per, nsplit = _grid(x, "instance_norm_stats")
    off = 2 * b * nsplit * 2 * c              # the f64 partials, in f32 slots
    ws = torch.empty(off + b * 2 * c, dtype=torch.float32, device=x.device)
    out = ws[off:].view(b, 2, c)
    fn = _build.function("instance_norm", "instance_norm_stats", _STATS_ARGTYPES)
    _build.check(fn(x.data_ptr(), ws.data_ptr(), out.data_ptr(), b, h * w, c,
                    rows_per, nsplit, _DTYPES[x.dtype], _build.stream_of(x)),
                 "instance_norm_stats")
    stats_launches += 1
    return out[:, 0], out[:, 1]


def _launch_fwd(x: Tensor, eps: float, relu: bool):
    """The norm entry on a checked CUDA tensor; counts the launch. Returns
    y and the f32 scratch, whose elements from ``off`` on hold mu, then
    rstd (B, C) each (no views made: the host's time is this path's
    cost at batch 1)."""
    global launches
    b, h, w, c = x.shape
    rows_per, nsplit = _grid(x, "instance_norm")
    y = torch.empty_like(x)
    off = 2 * b * nsplit * 2 * c              # the f64 partials, in f32 slots
    ws = torch.empty(off + 2 * b * c, dtype=torch.float32, device=x.device)
    part = ws.data_ptr()
    mu = part + 4 * off
    fn = _build.function("instance_norm", "instance_norm_fwd", _FWD_ARGTYPES)
    _build.check(fn(x.data_ptr(), y.data_ptr(), part, mu, mu + 4 * b * c, b,
                    h * w, c, rows_per, nsplit, eps, int(relu), _DTYPES[x.dtype],
                    _build.stream_of(x)), "instance_norm")
    launches += 1
    return y, ws, off


def _stats(x: Tensor):
    """The statistics kernel on CUDA tensors, the plain version on CPU
    tensors; its work added to an active ``utils.costs`` counter."""
    if _plain(x, "instance_norm_stats"):
        with costs.suspended():
            out = instance_norm_stats_plain(x)
    else:
        out = _launch_stats(x)
    if costs.active:
        costs.kernel("instance_norm_stats", costs.instance_norm_stats, x)
    return out


class _Stats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _stats(x)

    @staticmethod
    def backward(ctx, gs, gss):
        (x,) = ctx.saved_tensors
        dx = gs[:, None, None, :] + 2.0 * x.float() * gss[:, None, None, :]
        return dx.to(x.dtype)


def instance_norm_stats(x: Tensor):
    """Per-(sample, channel) spatial sum and sum of squares, f32;
    differentiable.

    :param x: (B, H, W, C), C <= 128; on CUDA contiguous NHWC
    :return: (sum (B, C), sumsq (B, C)) f32
    """
    return _Stats.apply(x)


def instance_norm_fwd(x: Tensor, eps: float = EPS, relu: bool = False):
    """The norm kernel on CUDA tensors, the plain version on CPU tensors;
    no gradient.

    :param x: (B, H, W, C), C <= 128; on CUDA contiguous NHWC
    :return: (y like x, mu (B, C) f32, rstd (B, C) f32)
    """
    if not _plain(x, "instance_norm"):
        y, ws, off = _launch_fwd(x, eps, relu)
        moments = ws[off:].view(2, x.shape[0], x.shape[3])
        return y, moments[0], moments[1]
    s, ss = instance_norm_stats_plain(x)
    return (_normalize(x, s, ss, eps, relu), *_moments(x, s, ss, eps))


def _forward(x: Tensor, eps: float, relu: bool) -> Tensor:
    if _plain(x, "instance_norm"):
        with costs.suspended():
            return instance_norm_plain(x, eps, relu)
    return _launch_fwd(x, eps, relu)[0]


class _InstanceNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, eps, relu):
        ctx.eps, ctx.relu = eps, relu
        ctx.save_for_backward(x)
        return _forward(x, eps, relu)

    @staticmethod
    def backward(ctx, gy):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xg = x.detach().requires_grad_()
            y = _normalize(xg, *instance_norm_stats(xg), ctx.eps, ctx.relu)
            (dx,) = torch.autograd.grad(y, xg, gy)
        return dx, None, None


def instance_norm(x: Tensor, eps: float = EPS, relu: bool = False) -> Tensor:
    """torch ``InstanceNorm2d(affine=False)`` over NHWC with the JAX
    package's formula (:func:`instance_norm_plain`), then a ReLU where
    ``relu``. For C <= 128 one ``instance_norm_fwd`` launch on a CUDA
    tensor, the plain version on a CPU tensor; for C > 128 plain means on
    every device.

    :param x: (B, H, W, C); on CUDA contiguous NHWC
    :return: (B, H, W, C) of x's dtype
    """
    if x.shape[-1] > MAX_C:
        xf = x.float()
        mu = xf.mean(dim=(1, 2), keepdim=True)
        ms = (xf * xf).mean(dim=(1, 2), keepdim=True)
        var = torch.clamp(ms - mu * mu, min=0.0)
        y = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
        return torch.relu(y) if relu else y
    if costs.active:
        costs.kernel("instance_norm", costs.instance_norm, x)
    if x.requires_grad and torch.is_grad_enabled():
        return _InstanceNorm.apply(x, eps, relu)
    return _forward(x, eps, relu)    # inference: no graph, nothing saved
