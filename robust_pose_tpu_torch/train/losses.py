"""Training losses (port of ``robust_pose_tpu/train/losses.py``)."""
from __future__ import annotations

import torch

from robust_pose_tpu_torch import se3

Tensor = torch.Tensor


def supervised_pose_loss(pose_tan_pred: Tensor, pose_gt_vec: Tensor) -> Tensor:
    """L1 between the predicted tangent-space pose and log(gt), (B, 6)."""
    return torch.abs(pose_tan_pred - se3.log(pose_gt_vec))


def loss_metrics(loss_pose: Tensor, prefix: str = "train") -> dict:
    """Rotation / translation / total parts of the per-sample pose loss,
    NaN samples skipped."""
    return {
        f"{prefix}/loss_rot": torch.nanmean(loss_pose[:, 3:].sum(-1)),
        f"{prefix}/loss_trans": torch.nanmean(loss_pose[:, :3].sum(-1)),
        f"{prefix}/loss_total": torch.nanmean(loss_pose.sum(-1)),
    }
