"""Trajectory metrics: ATE-RMSE (Horn-prealigned) and RPE (port of
``robust_pose_tpu/utils/metrics.py``, the port's own copy: host-side numpy
on (N, 4, 4) pose matrices).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def horn_align(model: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Closed-form (Horn) rigid alignment of two 3xN point sets; returns the
    4x4 transform mapping ``model`` onto ``data``
    (reference trajectory_metrics.py:7-35)."""
    model = np.asarray(model, dtype=float)
    data = np.asarray(data, dtype=float)
    model_zc = model - model.mean(1, keepdims=True)
    data_zc = data - data.mean(1, keepdims=True)
    W = model_zc @ data_zc.T
    U, _, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vh
    trans = data.mean(1, keepdims=True) - rot @ model.mean(1, keepdims=True)
    T = np.eye(4)
    T[:3, :3] = rot
    T[:3, 3] = trans.squeeze()
    return T


def absolute_trajectory_error(gt_poses: np.ndarray, predicted_poses: np.ndarray,
                              prealign: bool = True, ret_align_T: bool = False,
                              ignore_failed_pos: bool = False):
    """ATE-RMSE over (N, 4, 4) pose arrays (reference
    trajectory_metrics.py:38-73). Identity-repeat predictions mark failed
    frames and can be excluded (``ignore_failed_pos``)."""
    assert len(gt_poses) == len(predicted_poses)
    gt_poses = np.asarray(gt_poses, dtype=float)
    predicted_poses = np.asarray(predicted_poses, dtype=float)

    if ignore_failed_pos:
        valid = np.ones(len(predicted_poses), dtype=bool)
        for i in range(len(predicted_poses) - 1):
            valid[i + 1] = (predicted_poses[i] - predicted_poses[i + 1]).sum() != 0
    else:
        valid = np.ones(len(predicted_poses), dtype=bool)

    T = None
    if prealign:
        T = horn_align(predicted_poses[valid, :3, 3].T, gt_poses[valid, :3, 3].T)
        predicted_poses = T[None] @ predicted_poses

    diffs = gt_poses[valid, :3, 3] - predicted_poses[valid, :3, 3]
    trans_err = np.sum(diffs ** 2, axis=-1)
    ate_rmse = float(np.sqrt(np.mean(trans_err)))
    if ret_align_T:
        return ate_rmse, np.sqrt(trans_err), T, valid
    return ate_rmse, np.sqrt(trans_err)


def relative_pose_error(gt_poses: np.ndarray, predicted_poses: np.ndarray,
                        delta: int = 1, ignore_failed_pos: bool = False
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """RPE translation / rotation over interval ``delta``
    (reference trajectory_metrics.py:76-105)."""
    assert len(gt_poses) == len(predicted_poses)
    gt_poses = np.asarray(gt_poses, dtype=float)
    predicted_poses = np.asarray(predicted_poses, dtype=float)
    trans_errors, rot_errors = [], []
    for i in range(len(gt_poses) - delta):
        if ((predicted_poses[i] - predicted_poses[i + 1]).sum() != 0) or \
                (not ignore_failed_pos):
            gt_rel = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
            pred_rel = np.linalg.inv(predicted_poses[i]) @ predicted_poses[i + delta]
            rel_err = np.linalg.inv(gt_rel) @ pred_rel
            trans_errors.append(np.sqrt(np.sum(rel_err[:3, 3] ** 2)))
            d = 0.5 * (np.trace(rel_err[:3, :3]) - 1)
            rot_errors.append(np.arccos(max(min(d, 1.0), -1.0)))
    return np.asarray(trans_errors), np.asarray(rot_errors)


def total_trajectory_length(translations: np.ndarray) -> float:
    """Sum of inter-frame translations over (N, 3)
    (reference trajectory_metrics.py:108-112)."""
    locs = np.asarray(translations, dtype=float)
    steps = np.sqrt(np.sum(np.diff(locs, axis=0) ** 2, axis=-1))
    return float(np.sum(steps))
