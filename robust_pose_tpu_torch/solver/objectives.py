"""Weighted 2D-reprojection + 3D point-to-point pose objectives (port of
``robust_pose_tpu/solver/objectives.py``). NHWC / points-last layout."""
from __future__ import annotations

from typing import NamedTuple

import torch

from robust_pose_tpu_torch import se3
from robust_pose_tpu_torch.ops.geometry import project, transform

Tensor = torch.Tensor


class PoseProblemInputs(NamedTuple):
    flow: Tensor        # (B, H, W, 2) temporal optical flow, pixels
    pcl1: Tensor        # (B, H, W, 3) frame-1 point cloud (normalized depth)
    pcl2: Tensor        # (B, H, W, 3) frame-2 point cloud, warped to frame 1
    weights1: Tensor    # (B, H, W, 1) 2D confidence in [0, 1]
    weights2: Tensor    # (B, H, W, 1) 3D confidence in [0, 1]
    mask1: Tensor       # (B, H, W, 1) bool
    mask2: Tensor       # (B, H, W, 1) bool
    intrinsics: Tensor  # (B, 3, 3)
    loss_weight: Tensor  # (B, 2) learned [w3d, w2d]


def reprojection_objective(flow, pcl1, weights1, mask1, intrinsics, pose,
                           img_coords) -> Tensor:
    b, h, w, _ = flow.shape
    warped = project(pcl1.reshape(b, -1, 3), intrinsics, pose)[..., :2]
    flow_off = img_coords[None, :, :2] + flow.reshape(b, -1, 2)
    residuals = ((flow_off - warped) ** 2).sum(-1) * weights1.reshape(b, -1)
    valid = ((flow_off[..., 0] > 0) & (flow_off[..., 1] > 0)
             & (flow_off[..., 0] < w) & (flow_off[..., 1] < h)
             & mask1.reshape(b, -1) & torch.isfinite(residuals))
    residuals = torch.where(valid, residuals, 0.0)
    return residuals.mean(dim=1) / (h * w)


def depth_objective(pcl1, pcl2, weights2, mask1, mask2, pose) -> Tensor:
    b = pcl1.shape[0]
    p1 = transform(pcl1.reshape(b, -1, 3), pose)
    residuals = ((p1 - pcl2.reshape(b, -1, 3)) ** 2).sum(-1) * weights2.reshape(b, -1)
    valid = (mask1 & mask2).reshape(b, -1)
    return torch.where(valid, residuals, 0.0).mean(dim=-1)


def objective(xs: PoseProblemInputs, pose: Tensor, img_coords: Tensor) -> Tensor:
    """Combined objective per batch element; ``loss_weight[:, 0]`` scales
    the 3D term, ``loss_weight[:, 1]`` the 2D term."""
    loss3d = depth_objective(xs.pcl1, xs.pcl2, xs.weights2, xs.mask1,
                             xs.mask2, pose)
    loss2d = reprojection_objective(xs.flow, xs.pcl1, xs.weights1, xs.mask1,
                                    xs.intrinsics, pose, img_coords)
    return xs.loss_weight[:, 1] * loss2d + xs.loss_weight[:, 0] * loss3d


def objective_at_tangent(eps: Tensor, pose: Tensor, xs: PoseProblemInputs,
                         img_coords: Tensor) -> Tensor:
    """``objective(xs, exp(eps) * pose)``: the objective under a left
    tangent perturbation, the parameterization the IFT backward
    differentiates."""
    return objective(xs, se3.retract(eps, pose), img_coords)
