"""Convolution and frozen BatchNorm layers with a compute dtype.

Parameters stay f32; a layer built with ``dtype=torch.bfloat16`` runs its
convolution in bf16 (the JAX package's ``nn.Conv(dtype=bf16)`` mixed
precision). The cast weights are cached and rebuilt only when a parameter
changes (its version counter or storage), so a forward pass does not pay
one cast per layer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor


def cached_cast(owner: nn.Module, tensors, dtype, make=None,
                slot: str = "_cast_cache"):
    """``make(*tensors)`` (default: ``tensors``) cast to ``dtype``, cached
    in ``owner.<slot>`` until one of ``tensors`` changes (in-place updates
    bump the version counter, ``.to(device)`` the storage)."""
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
    """Frozen BatchNorm2d on running statistics (flax ``BatchNorm`` with
    ``use_running_average``): ``(x - mean) * (weight * rsqrt(var + eps)) +
    bias``, computed in f32 and cast to the input dtype. NCHW."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: Tensor) -> Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = ((x.float() - self.running_mean[:, None, None]) * mul[:, None, None]
             + self.bias[:, None, None])
        return y.to(x.dtype)
