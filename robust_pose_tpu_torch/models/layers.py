"""Convolution and BatchNorm layers with a compute dtype.

Parameters stay f32; a layer built with ``dtype=torch.bfloat16`` runs its
convolution in bf16 (the JAX package's ``nn.Conv(dtype=bf16)`` mixed
precision). Outside autograd the cast weights are cached and rebuilt only
when a parameter changes (its version counter or storage), so a forward
pass does not pay one cast per layer; while autograd records, the cast is
part of the graph, so the gradient reaches the f32 parameter.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from robust_pose_tpu_torch.parallel.mesh import all_reduce_sum

Tensor = torch.Tensor


def cached_cast(owner: nn.Module, tensors, dtype, make=None,
                slot: str = "_cast_cache"):
    """``make(*tensors)`` (default: ``tensors``) cast to ``dtype``. When
    grad mode is on and a tensor requires grad the result is computed in
    the graph; otherwise it is cached in ``owner.<slot>`` until one of
    ``tensors`` changes (in-place updates bump the version counter,
    ``.to(device)`` the storage)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        vals = make(*tensors) if make is not None else tensors
        return tuple(v.to(dtype) for v in vals)
    key = (dtype,) + tuple((t._version, t.data_ptr()) for t in tensors)
    cache = owner.__dict__.get(slot)
    if cache is None or cache[0] != key:
        with torch.no_grad():
            vals = make(*tensors) if make is not None else tensors
            out = tuple(v.to(dtype) for v in vals)
        owner.__dict__[slot] = cache = (key, out)
    return cache[1]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` running in ``dtype`` (input, weight and bias cast)."""

    def __init__(self, cin, cout, kernel_size, stride=1, padding=0,
                 dtype=torch.float32):
        super().__init__(cin, cout, kernel_size, stride=stride, padding=padding)
        self.compute_dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        w, b = cached_cast(self, (self.weight, self.bias), self.compute_dtype)
        return F.conv2d(x.to(self.compute_dtype), w, b, self.stride,
                        self.padding)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` running in ``dtype``."""

    def __init__(self, cin, cout, kernel_size, stride, dtype=torch.float32):
        super().__init__(cin, cout, kernel_size, stride=stride)
        self.compute_dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        w, b = cached_cast(self, (self.weight, self.bias), self.compute_dtype)
        return F.conv_transpose2d(x.to(self.compute_dtype), w, b, self.stride)


class BatchNorm(nn.Module):
    """BatchNorm over NCHW with flax ``BatchNorm``'s semantics, computed in
    f32 and cast to the input dtype: ``(x - mean) * (weight * rsqrt(var +
    eps)) + bias``.

    ``forward(x)`` uses the running statistics (flax
    ``use_running_average=True``; the RAFT encoders always do). With
    ``train=True`` it uses the batch mean and the biased batch variance
    ``max(E[x^2] - E[x]^2, 0)`` and updates the running statistics as flax
    does, ``ra = 0.99 ra + 0.01 batch`` (flax's momentum 0.99) with the
    biased variance (``F.batch_norm`` would use the unbiased one and
    torch's momentum convention).

    ``train=True`` with ``mesh`` (a ``parallel.mesh.Mesh`` with a process
    group, world 1 included) takes the statistics of the global batch, as
    the JAX SPMD step does: each rank's per-channel means of x and x^2,
    divided by the world size, summed by one differentiable all-reduce
    (its backward carries the other ranks' terms). The ranks hold equal
    shares of the batch (``parallel.mesh.shard_batch``), so that is the
    global mean; at world 1 the division and the sum leave today's bits.
    The running statistics then take the global values, equal on every
    rank. Without a process group the statistics are the local batch's."""

    MOMENTUM = 0.99

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: Tensor, train: bool = False, mesh=None) -> Tensor:
        xf = x.float()
        if train:
            mean = xf.mean(dim=(0, 2, 3))
            sq = (xf * xf).mean(dim=(0, 2, 3))
            if mesh is not None and mesh.distributed:
                mean, sq = all_reduce_sum(
                    mesh, torch.stack([mean, sq]) / mesh.world_size)
            var = torch.clamp(sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)
