"""Metric logging (port of ``robust_pose_tpu/utils/logging.py``): the same
metric names and semantics (per-frame surfel counts and pose-error
decomposition, a running-mean training accumulator with a console table),
with wandb optional: console only when it is missing or disabled. wandb
is imported when a logger that logs is made.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from scipy.spatial.transform import Rotation as R

from robust_pose_tpu_torch.utils.trajectory import vec2mat


def _wandb(enabled: bool):
    """The wandb module where logging is asked for and wandb is installed,
    else None."""
    if not enabled:
        return None
    try:
        import wandb
    except ImportError:  # wandb optional
        return None
    return wandb


def _host(x) -> np.ndarray:
    """A pose vector as a host array (a device tensor is fetched)."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


class InferenceLogger:
    """Per-frame inference logging (reference logging.py:6-52)."""

    def __init__(self, log: Optional[str] = None):
        self.gt_trajectory = None
        self.wandb = _wandb(log is not None)
        self.enabled = self.wandb is not None
        self.history = []

    def set_gt(self, gt_trajectory):
        """gt_trajectory: (N, 7) pose vecs or None."""
        if gt_trajectory is not None:
            self.gt_trajectory = vec2mat(np.asarray(gt_trajectory))

    def __call__(self, scene, pose_vec, step: int):
        if scene is not None:
            surfels_total = int(scene.n_active)
            surfels_stable = int(((scene.state.conf >= 1.0)
                                  & scene.state.active).sum())
        else:
            surfels_total = 0
            surfels_stable = 0

        log_dict = {"frame": step, "surfels/total": surfels_total,
                    "surfels/stable": surfels_stable}
        pose = vec2mat(_host(pose_vec))[0]
        if self.gt_trajectory is not None and len(self.gt_trajectory) > step:
            gt = self.gt_trajectory[step]
            tr_err = gt[:3, 3] - pose[:3, 3]
            rot_err = gt[:3, :3].T @ pose[:3, :3]
            rot_err_deg = np.linalg.norm(
                R.from_matrix(rot_err).as_rotvec(degrees=True), ord=2)
            euler_pred = R.from_matrix(pose[:3, :3]).as_euler("zxy", degrees=True)
            euler_gt = R.from_matrix(gt[:3, :3]).as_euler("zxy", degrees=True)
            log_dict.update({
                "error/x": tr_err[0], "error/y": tr_err[1],
                "error/z": tr_err[2], "error/rot": rot_err_deg,
                "error/x_pred": pose[0, 3], "error/y_pred": pose[1, 3],
                "error/z_pred": pose[2, 3],
                "error/alpha_pred": euler_pred[0],
                "error/beta_pred": euler_pred[1],
                "error/gamma_pred": euler_pred[2],
                "error/x_gt": gt[0, 3], "error/y_gt": gt[1, 3],
                "error/z_gt": gt[2, 3],
                "error/alpha_gt": euler_gt[0], "error/beta_gt": euler_gt[1],
                "error/gamma_gt": euler_gt[2],
            })
        self.history.append(log_dict)
        if self.enabled:
            self.wandb.log(log_dict, step=step)

    def summary(self, metrics: Dict):
        if self.enabled:
            for k, v in metrics.items():
                self.wandb.summary[k] = v


class TrainLogger:
    """Running-mean metric accumulator with console table
    (reference logging.py:55-112)."""

    def __init__(self, config: Dict, project_name: str = "robust-pose-tpu",
                 log: bool = False):
        self.total_steps = 0
        self.running_loss = {"train": {}, "val": {}}
        self.wandb = _wandb(log)
        self.log = self.wandb is not None
        if self.log:
            self.wandb.init(project=project_name, config=config)
        self.header = False

    def _print_header(self):
        keys = sorted(self.running_loss["train"].keys())
        print(("{:<15}, " * len(keys)).format(*keys))

    def _print_training_status(self, mode):
        if not self.header:
            self.header = True
            self._print_header()
        vals = [self.running_loss[mode][k]
                for k in sorted(self.running_loss[mode].keys())]
        print(("{:10.4f}, " * len(vals)).format(*vals))
        for k in self.running_loss[mode]:
            self.running_loss[mode][k] = 0.0

    def push(self, metrics: Dict, freq: int, mode: str = "train"):
        self.total_steps += 1
        for key, v in metrics.items():
            self.running_loss[mode].setdefault(key, 0.0)
            self.running_loss[mode][key] += float(v) / freq

    def flush(self, mode: str = "train"):
        if self.log:
            self.wandb.log(self.running_loss[mode])
        self._print_training_status(mode)
        self.running_loss[mode] = {}

    def save_model(self, path: str):
        if self.log:
            self.wandb.save(path)

    def close(self):
        if self.log:
            self.wandb.finish()
