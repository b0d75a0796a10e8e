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


def matvec3(m: Tensor, p: Tensor) -> Tensor:
    """``p @ m^T`` for points ``p (..., 3)`` and a (3, 3) matrix, written
    out as separately rounded products and left-to-right sums. That is how
    the JAX package's f32 product of this shape rounds on the CPU, and
    elementwise tensor ops round the same way on the card, so pixel
    quantizations of the result agree bit for bit."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return torch.stack([x * m[0, 0] + y * m[0, 1] + z * m[0, 2],
                        x * m[1, 0] + y * m[1, 1] + z * m[1, 2],
                        x * m[2, 0] + y * m[2, 1] + z * m[2, 2]], dim=-1)


def inv_upper3(m: Tensor) -> Tensor:
    """Inverse of an upper-triangular (3, 3) matrix, such as pinhole
    intrinsics, by back substitution with the reciprocals of the diagonal:
    the order in which the JAX package's LU solve rounds it on the CPU (a
    LAPACK inverse differs in the last bit for ~40 % of intrinsics)."""
    r = 1.0 / torch.diagonal(m)
    e = torch.eye(3, dtype=m.dtype, device=m.device)
    x2 = e[2] * r[2]
    x1 = (e[1] - m[1, 2] * x2) * r[1]
    x0 = ((e[0] - m[0, 1] * x1) - m[0, 2] * x2) * r[0]
    return torch.stack([x0, x1, x2])


def project2image(opts: Tensor, kmat: Tensor, img_shape, pose: Tensor | None = None):
    """Pinhole projection of points (N, 3) by one (3, 3) intrinsics matrix
    and an optional (7,) pose, and the in-image flag.

    :return: (ipts (N, 3) homogeneous pixel coords, valid (N,) bool)
    """
    h, w = img_shape
    if pose is not None:
        opts = se3.act(pose[None], opts)
    ipts = matvec3(kmat, opts)
    depth = torch.clamp(ipts[..., -1:], min=1e-12)
    ipts = torch.cat([ipts[..., :2] / depth, torch.ones_like(depth)], dim=-1)
    valid = ((ipts[..., 1] < h) & (ipts[..., 0] < w)
             & (ipts[..., 1] >= 0) & (ipts[..., 0] >= 0))
    return ipts, valid


def depth_to_pcl(depth: Tensor, intrinsics: Tensor, img_coords: Tensor):
    """(B, H, W, 1) depth -> (B, H, W, 3) point cloud."""
    b, h, w, _ = depth.shape
    rays = img_coords @ _inv3(intrinsics).transpose(-1, -2)
    if rays.ndim == 2:
        rays = rays[None]
    return (depth.reshape(b, -1, 1) * rays).reshape(b, h, w, 3)
