"""Instance-norm statistics kernel (Triton) and ``instance_norm``.

Replaces ``robust_pose_tpu/ops/pallas_instance_norm.py::_stats_kernel``
(reached through ``instance_norm_stats``): per-(sample, channel) sum and
sum of squares over H x W in one pass with f32 accumulation, for C <= 128.
It serves all 15 instance norms of every fnet pass.

What bounds it on an H100: it reads each input element once (2 bytes in
bf16) and does two FMAs per element, so device-memory bytes bound it
(about 170 MB per 256x320x64 norm at batch 16, ~50 us at 3.35 TB/s).

Design: pass 1 runs a grid of (sample, row chunk); each program streams
its rows of the contiguous NHWC tensor as (BLOCK_R, C) tiles, with
neighbouring threads on neighbouring channels (coalesced), accumulates
sum and sum of squares in f32 registers and writes one (2, C) partial.
There are enough chunks to give every SM several programs. Pass 2 runs one
program per sample and adds the partials in a fixed order (no atomics, so
two runs give the same bits).

Layout the kernel takes: x (B, H, W, C) contiguous NHWC -- the NHWC view
(``permute(0, 2, 3, 1)``) of a ``channels_last`` NCHW tensor, which is how
the RAFT encoders keep their activations. The wrapper checks it.

Gradient: ``instance_norm_stats`` is a ``torch.autograd.Function`` on both
devices, with the JAX package's custom VJP as its backward,
``dx = gs + 2 x gss`` (elementwise, plain PyTorch, as the JAX package
leaves it to XLA).
"""
from __future__ import annotations

import torch

from robust_pose_tpu_torch.device import plain_or_cuda

Tensor = torch.Tensor

launches = 0          # kernel launches (pass 1 + pass 2 count as one)
MAX_C = 128           # the kernel's channel limit (the TPU kernel's lane width)

tl = None             # bound to ``triton.language`` on the first launch
_kernels = None


def _stats_partial(x_ptr, part_ptr, HW, C, rows_per_prog,
                   BLOCK_R: "tl.constexpr", BLOCK_C: "tl.constexpr"):
    b = tl.program_id(0)
    s = tl.program_id(1)
    nsplit = tl.num_programs(1)
    rows0 = tl.arange(0, BLOCK_R)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < C
    acc = tl.zeros((BLOCK_R, BLOCK_C), dtype=tl.float32)
    acc2 = tl.zeros((BLOCK_R, BLOCK_C), dtype=tl.float32)
    base = x_ptr + b.to(tl.int64) * HW * C
    start = s * rows_per_prog
    for r in range(start, start + rows_per_prog, BLOCK_R):
        rows = r + rows0
        m = (rows < HW)[:, None] & cmask[None, :]
        v = tl.load(base + rows[:, None] * C + cols[None, :], mask=m,
                    other=0.0).to(tl.float32)
        acc += v
        acc2 += v * v
    out = part_ptr + ((b * nsplit + s) * 2) * C
    tl.store(out + cols, tl.sum(acc, axis=0), mask=cmask)
    tl.store(out + C + cols, tl.sum(acc2, axis=0), mask=cmask)


def _stats_finish(part_ptr, out_ptr, nsplit, C, BLOCK_C: "tl.constexpr"):
    b = tl.program_id(0)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < C
    s1 = tl.zeros((BLOCK_C,), dtype=tl.float32)
    s2 = tl.zeros((BLOCK_C,), dtype=tl.float32)
    for s in range(0, nsplit):
        p = part_ptr + ((b * nsplit + s) * 2) * C
        s1 += tl.load(p + cols, mask=cmask, other=0.0)
        s2 += tl.load(p + C + cols, mask=cmask, other=0.0)
    tl.store(out_ptr + (b * 2) * C + cols, s1, mask=cmask)
    tl.store(out_ptr + (b * 2 + 1) * C + cols, s2, mask=cmask)


def _triton_kernels():
    """Import Triton and JIT the two kernels (first launch only)."""
    global tl, _kernels
    if _kernels is None:
        import triton
        import triton.language as tl  # noqa: F811 (binds the module global)

        _kernels = (triton.jit(_stats_partial), triton.jit(_stats_finish))
    return _kernels


def instance_norm_stats_plain(x: Tensor):
    """Plain version: (sum, sum of squares) over H, W in f32, (B, C) each."""
    xf = x.float()
    return xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2))


def _stats(x: Tensor):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    global launches
    b, h, w, c = x.shape
    if c > MAX_C:
        raise ValueError(f"instance_norm_stats: C = {c} > {MAX_C}")
    if plain_or_cuda(x, "instance_norm_stats"):
        return instance_norm_stats_plain(x)
    if not x.is_contiguous():
        raise ValueError("instance_norm_stats: the kernel takes a contiguous "
                         "NHWC tensor (the NHWC view of a channels_last one)")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"instance_norm_stats: dtype {x.dtype}")
    partial_k, finish_k = _triton_kernels()
    hw = h * w
    block_c = max(16, 1 << (c - 1).bit_length())
    block_r = max(1, 4096 // block_c)
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    nsplit = max(1, min(-(-hw // block_r), -(-4 * n_sm // b)))
    rows_per_prog = -(-hw // nsplit)
    rows_per_prog = -(-rows_per_prog // block_r) * block_r
    nsplit = -(-hw // rows_per_prog)
    part = torch.empty((b, nsplit, 2, c), dtype=torch.float32, device=x.device)
    out = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    partial_k[(b, nsplit)](x, part, hw, c, rows_per_prog, BLOCK_R=block_r,
                           BLOCK_C=block_c, num_warps=8)
    finish_k[(b,)](part, out, nsplit, c, BLOCK_C=block_c, num_warps=4)
    launches += 1
    return out[:, 0], out[:, 1]


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


def instance_norm(x: Tensor, eps: float = 1e-5) -> Tensor:
    """torch ``InstanceNorm2d(affine=False)`` over NHWC with the JAX
    package's formula: var = max(E[x^2] - E[x]^2, 0), rsqrt(var + eps),
    result cast back to the input dtype."""
    b, h, w, c = x.shape
    if c > MAX_C:
        xf = x.float()
        mu = xf.mean(dim=(1, 2), keepdim=True)
        ms = (xf * xf).mean(dim=(1, 2), keepdim=True)
    else:
        s, ss = instance_norm_stats(x)
        cnt = float(h * w)
        mu = (s / cnt)[:, None, None, :]
        ms = (ss / cnt)[:, None, None, :]
    var = torch.clamp(ms - mu * mu, min=0.0)
    return ((x.float() - mu) * torch.rsqrt(var + eps)).to(x.dtype)
