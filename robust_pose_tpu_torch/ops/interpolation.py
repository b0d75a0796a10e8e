"""Sparse image interpolation (port of
``robust_pose_tpu/ops/interpolation.py``): NaN pixels filled with a
centre-zeroed Gaussian (or a median) of their neighbourhood. NHWC."""
from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _gauss_kernel_2d(size: int, std: float, device=None) -> Tensor:
    """Centre-zeroed, normalized 2D Gaussian (size, size) in f32."""
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1.0) / 2.0
    g1 = torch.exp(-(x ** 2) / (2 * std ** 2))
    g2 = torch.outer(g1, g1)
    g2[size // 2, size // 2] = 0.0
    return g2 / torch.sum(g2)


def sparse_img_interpolate(x: Tensor, kernel_size: int = 5, sigma: float = 2.0,
                           prior_val: float = 0.0) -> Tensor:
    """Replace the NaN pixels of ``x (B, H, W, C)`` by the Gaussian-weighted
    mean of their reflect-padded neighbourhood (a depthwise convolution)."""
    mask = torch.isnan(x)
    x = torch.where(mask, prior_val, x)
    pad = kernel_size // 2
    c = x.shape[-1]
    k = _gauss_kernel_2d(kernel_size, sigma, x.device).to(x.dtype)
    padded = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    conv = F.conv2d(padded, k.expand(c, 1, kernel_size, kernel_size),
                    groups=c).permute(0, 2, 3, 1)
    return torch.where(mask, conv, x)


def median_filter_2d(x: Tensor, kernel_size: int = 3) -> Tensor:
    """Same-size 2D median filter of ``x (B, H, W, C)`` over the
    edge-replicated image, as ``jnp.median``: the middle of the sorted k²
    taps, and for an even count the midpoint of the middle two (where
    ``torch.median`` would take the lower one)."""
    pad = kernel_size // 2
    b, h, w, c = x.shape
    padded = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad),
                   mode="replicate").permute(0, 2, 3, 1)
    patches = torch.stack([padded[:, i:i + h, j:j + w, :]
                           for i in range(kernel_size)
                           for j in range(kernel_size)], dim=-1)
    taps = torch.sort(patches, dim=-1).values
    m = kernel_size * kernel_size // 2
    if kernel_size % 2:
        return taps[..., m]
    return (taps[..., m - 1] + taps[..., m]) * 0.5


def sparse_median_interpolate(x: Tensor, kernel_size: int = 3,
                              prior_val: float = 0.0) -> Tensor:
    """NaN fill of ``x (B, H, W, C)`` by the median of the neighbourhood."""
    mask = torch.isnan(x)
    x = torch.where(mask, prior_val, x)
    return torch.where(mask, median_filter_2d(x, kernel_size), x)
