"""ATE/RPE trajectory evaluation against TUM/Freiburg files (port of
``robust_pose_tpu/utils/evaluate.py``): timestamp matching with an offset,
Horn pre-alignment, ATE-RMSE and RPE statistics, on the port's own
``utils.trajectory`` and ``utils.metrics``.

    python -m robust_pose_tpu_torch.utils.evaluate groundtruth.txt trajectory.freiburg
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np

from robust_pose_tpu_torch.utils.metrics import (
    absolute_trajectory_error,
    relative_pose_error,
    total_trajectory_length,
)
from robust_pose_tpu_torch.utils.trajectory import read_freiburg, vec2mat


def _as_pose_dict(src: Union[str, dict]) -> dict:
    if isinstance(src, dict):
        return src
    poses, stamps = read_freiburg(src, ret_stamps=True)
    return {int(k): p for k, p in zip(stamps, poses)}


def evaluate(gt_list: Union[str, dict], pred_list: Union[str, dict],
             delta: int = 1, offset: int = 0, ret_align_T: bool = False,
             ignore_failed_pos: bool = False):
    """Timestamp-matched ATE + RPE (reference evaluate_ate_freiburg.py:6-31).

    :return: (ate_rmse, mean rpe_trans, mean rpe_rot, trans_error,
        rpe_trans, rpe_rot[, transform, gt_poses, valid])
    """
    gt = _as_pose_dict(gt_list)
    pred = _as_pose_dict(pred_list)

    pred_keys = sorted(pred.keys())
    gt_keys = sorted(gt.keys())
    pred_poses, gt_poses = [], []
    for k in pred_keys:
        if (k + offset > 0) and (k + offset < max(gt_keys)):
            if (k + offset) not in gt:
                continue
            pred_poses.append(vec2mat(pred[k])[0])
            gt_poses.append(vec2mat(gt[k + offset])[0])
    if not pred_poses:
        raise ValueError(
            "no overlapping timestamps between prediction and ground truth "
            f"(offset={offset}, pred range {pred_keys[0]}..{pred_keys[-1]}, "
            f"gt range {gt_keys[0]}..{gt_keys[-1]})")
    pred_poses = np.stack(pred_poses)
    gt_poses = np.stack(gt_poses)

    ate_rmse, trans_error, transform, valid = absolute_trajectory_error(
        gt_poses, pred_poses, ret_align_T=True,
        ignore_failed_pos=ignore_failed_pos,
    )
    rpe_trans, rpe_rot = relative_pose_error(
        gt_poses, pred_poses, delta=delta, ignore_failed_pos=ignore_failed_pos
    )
    if ret_align_T:
        return (ate_rmse, float(np.mean(rpe_trans)), float(np.mean(rpe_rot)),
                trans_error, rpe_trans, rpe_rot, transform, gt_poses, valid)
    return (ate_rmse, float(np.mean(rpe_trans)), float(np.mean(rpe_rot)),
            trans_error, rpe_trans, rpe_rot)


def get_traj_length(gt_list: Union[str, dict],
                    pred_list: Optional[Union[str, dict]] = None,
                    offset: int = 0) -> float:
    """Ground-truth trajectory length over the evaluated window
    (reference evaluate_ate_freiburg.py:34-52)."""
    gt = _as_pose_dict(gt_list)
    if pred_list is not None:
        pred = _as_pose_dict(pred_list)
        gt_keys = sorted(gt.keys())
        poses = [gt[k + offset] for k in sorted(pred.keys())
                 if 0 < k + offset < max(gt_keys) and (k + offset) in gt]
    else:
        poses = [gt[k] for k in sorted(gt.keys())]
    locs = np.stack([np.asarray(p)[:3] for p in poses])
    return total_trajectory_length(locs)


def main():
    """CLI mirroring reference evaluate_ate_freiburg.py __main__ (lines 55-75)."""
    import argparse

    parser = argparse.ArgumentParser(description="Compute Trajectory Metrics")
    parser.add_argument("gt_file", type=str,
                        help="ground truth trajectory (timestamp tx ty tz qx qy qz qw)")
    parser.add_argument("pred_file", type=str,
                        help="estimated trajectory (timestamp tx ty tz qx qy qz qw)")
    parser.add_argument("--delta", type=int, default=1,
                        help="interval for relative pose error")
    parser.add_argument("--offset", type=int, default=0)
    args = parser.parse_args()

    ate_rmse, rpe_t, rpe_r, trans_error, *_ = evaluate(
        args.gt_file, args.pred_file, args.delta, args.offset
    )
    print("compared_pose_pairs %d pairs" % (len(trans_error)))
    print("absolute_translational_error.rmse %f mm" % ate_rmse)
    print("absolute_translational_error.mean %f mm" % np.mean(trans_error))
    print("absolute_translational_error.median %f mm" % np.median(trans_error))
    print("absolute_translational_error.std %f mm" % np.std(trans_error))
    print("absolute_translational_error.min %f mm" % np.min(trans_error))
    print("absolute_translational_error.max %f mm" % np.max(trans_error))
    print("relative_pose_error.trans %f mm" % rpe_t)
    print("relative_pose_error.rot %f deg" % np.rad2deg(rpe_r))


if __name__ == "__main__":
    main()
