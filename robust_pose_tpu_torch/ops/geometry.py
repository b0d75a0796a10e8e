"""Pinhole-camera geometry (port of ``robust_pose_tpu/ops/geometry.py``).

Point clouds are points-last ``(B, N, 3)`` / ``(B, H, W, 3)`` as in the JAX
package. Everything runs in f32; on the card the caller keeps TF32 off for
f32 matrix products (PyTorch's default for ``matmul``).
"""
from __future__ import annotations

import torch

from robust_pose_tpu_torch import se3

Tensor = torch.Tensor


def _inv3(m: Tensor) -> Tensor:
    # inv_ex: no host sync for the error check (K is always invertible)
    return torch.linalg.inv_ex(m)[0]


def create_img_coords(height: int, width: int, dtype=torch.float32,
                      device=None) -> Tensor:
    """Homogeneous pixel grid (H*W, 3) with the +0.5 pixel-centre offset."""
    xs = torch.arange(width, dtype=dtype, device=device) + 0.5
    ys = torch.arange(height, dtype=dtype, device=device) + 0.5
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xg.reshape(-1), yg.reshape(-1),
                        torch.ones_like(xg).reshape(-1)], dim=-1)


def transform(opts: Tensor, pose: Tensor) -> Tensor:
    """Rigid transform of points (B, N, 3) by poses (B, 7) or (7,)."""
    if pose.ndim == opts.ndim - 1:
        pose = pose[..., None, :]
    return se3.act(pose, opts)


def project(opts: Tensor, intrinsics: Tensor, pose: Tensor | None = None):
    """Pinhole projection K @ [T @] X with depth clamping -> (B, N, 3)."""
    if pose is not None:
        opts = transform(opts, pose)
    ipts = opts @ intrinsics.transpose(-1, -2)
    depth = torch.clamp(ipts[..., -1:], min=1e-12)
    return torch.cat([ipts[..., :2] / depth, torch.ones_like(depth)], dim=-1)


def depth_to_pcl(depth: Tensor, intrinsics: Tensor, img_coords: Tensor):
    """(B, H, W, 1) depth -> (B, H, W, 3) point cloud."""
    b, h, w, _ = depth.shape
    rays = img_coords @ _inv3(intrinsics).transpose(-1, -2)
    if rays.ndim == 2:
        rays = rays[None]
    return (depth.reshape(b, -1, 1) * rays).reshape(b, h, w, 3)
