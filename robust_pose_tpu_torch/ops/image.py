"""Small image tensor ops (port of ``robust_pose_tpu/ops/image.py``):
Sobel gradients, a batched dot product and a batched identity."""
from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def image_gradient(img: Tensor) -> Tensor:
    """Sobel x/y gradients of (B, C, H, W) -> (B, 2*C, H, W): a
    cross-correlation over the edge-replicated image, as the JAX package's
    ``jnp.pad(mode="edge")`` + ``conv_general_dilated`` (neither flips the
    kernel)."""
    kx = torch.tensor([[1.0, 0.0, -1.0], [2.0, 0.0, -2.0], [1.0, 0.0, -1.0]],
                      dtype=img.dtype, device=img.device)
    b, c, h, w = img.shape
    xp = F.pad(img.reshape(b * c, 1, h, w), (1, 1, 1, 1), mode="replicate")
    gx = F.conv2d(xp, kx[None, None]).reshape(b, c, h, w)
    gy = F.conv2d(xp, kx.T[None, None]).reshape(b, c, h, w)
    return torch.cat([gx, gy], dim=1)


def batched_dot_product(a: Tensor, b: Tensor) -> Tensor:
    """(B, N, D) x (B, N, D) -> (B, N, 1)."""
    return torch.sum(a * b, dim=-1, keepdim=True)


def beye(batch: int, n: int, dtype=torch.float32, device=None) -> Tensor:
    """Batched identity (B, n, n), a broadcast view of one identity."""
    return torch.eye(n, dtype=dtype, device=device).expand(batch, n, n)
