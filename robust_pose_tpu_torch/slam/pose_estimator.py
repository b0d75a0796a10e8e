"""Frame-to-frame stereo camera pose estimator (port of the f2f paths of
``robust_pose_tpu/slam/pose_estimator.py``).

A solved relative pose that is non-finite or has |log| > 0.1 is replaced by
the identity (``_rel_check``); absolute poses chain as ``last * rel^-1``.
Frame-to-model tracking (the surfel map) waits for a later slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from robust_pose_tpu_torch import se3
from robust_pose_tpu_torch.device import resolve_device
from robust_pose_tpu_torch.models.posenet import PoseNet
from robust_pose_tpu_torch.slam.frame import Frame, make_frame

Tensor = torch.Tensor


class PoseEstimator:
    """:param config: SLAM config (frame2frame, depth_clipping,
        conf_weighing, lbgfs_iters; configuration/infer_f2f.yaml)
    :param intrinsics: (3, 3) rectified intrinsics
    :param baseline: stereo baseline in pixels
    :param checkpoint: {'state_dict': port state_dict, 'config': {'model':
        ...}}; the model config is rewritten with the SLAM config's image
        shape, solver iterations and conf_weighing
    :param img_shape: (width, height)
    :param init_pose: (7,) initial SE(3) vec
    :param device: ``cuda`` unless given; ``"cpu"`` runs the plain versions
    """

    def __init__(self, config: dict, intrinsics, baseline: float,
                 checkpoint: dict, img_shape: Tuple[int, int],
                 init_pose=None, device=None):
        if not config.get("frame2frame", True):
            raise NotImplementedError(
                "frame-to-model tracking is not ported yet (ROADMAP.md, "
                "queue A: f2m + surfel map)")
        self.device = resolve_device(device)
        model_config = dict(checkpoint["config"]["model"])
        model_config["image_shape"] = (img_shape[1], img_shape[0])
        model_config["lbgfs_iters"] = config["lbgfs_iters"]
        model_config["use_weights"] = config["conf_weighing"]
        self.config = config
        self.model_config = model_config
        self.model = PoseNet(model_config, device=self.device)
        self.model.load_state_dict(checkpoint["state_dict"])

        self.intrinsics = torch.as_tensor(
            np.asarray(intrinsics, np.float32), device=self.device)[None]
        self.scale = float(1.0 / config["depth_clipping"][1])
        self.baseline = torch.tensor([baseline], dtype=torch.float32,
                                     device=self.device)
        self.last_pose = (se3.identity((1,), device=self.device)
                          if init_pose is None else
                          self._tensor(init_pose, torch.float32).reshape(1, 7))
        self.last_frame: Optional[Frame] = None
        self.frame: Optional[Frame] = None
        self.scene = None
        self.success = True
        self._feats = None
        self.last_solver_iters = None

    def _tensor(self, x, dtype):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x
                               ).to(self.device, dtype)

    def _rel_check(self, rel: Tensor):
        """(rel (B, 7) in world depth units, success (B,) bool): a
        non-finite or |log| > 0.1 relative pose becomes the identity."""
        bad = ((~torch.isfinite(rel)).any(-1)
               | (se3.log(rel).abs() > 0.1).any(-1))
        ident = se3.identity((rel.shape[0],), device=rel.device)
        rel = torch.where(bad[:, None], ident, rel)
        return se3.scale(rel, 1.0 / self.scale), ~bad

    def _first_step(self, limg, rimg, mask):
        depth, valid, stereo_flow = self.model.flow2depth(
            limg, rimg, self.baseline * self.scale)
        feats = self.model.encode_ref(limg)
        frame = make_frame(limg, rimg, depth=depth / self.scale, mask=mask,
                           flow=stereo_flow)
        return frame, valid, feats

    def _track_step(self, last_pose, last: Frame, limg, rimg, mask, feats):
        out = self.model.infer(
            last.img, limg, self.intrinsics, self.baseline * self.scale,
            last.depth * self.scale, rimg, last.mask, mask, last.flow,
            feats=feats)
        rel, success = self._rel_check(out.pose)
        new_pose = se3.normalize(se3.mul(last_pose, se3.inv(rel)))
        frame = make_frame(limg, rimg, depth=out.depth2 / self.scale,
                           mask=mask, flow=out.stereo_flow2)
        return new_pose, frame, out, success[0]

    def _window_step(self, limgs, rimgs, masks):
        """One batched pass over T frames; only the (T, 7) pose chain is
        sequential."""
        frame = self.frame
        out = self.model.infer_window(
            limgs[:, 0], rimgs[:, 0], masks[:, 0], self.intrinsics,
            self.baseline * self.scale, frame.img, frame.depth * self.scale,
            frame.mask, frame.flow, self._feats)
        rel, success = self._rel_check(out.pose)
        pose = self.last_pose
        poses = []
        for r in rel:
            pose = se3.normalize(se3.mul(pose, se3.inv(r[None])))
            poses.append(pose)
        fr_state = make_frame(limgs[-1], rimgs[-1],
                              depth=out.depth2[-1:] / self.scale,
                              mask=masks[-1], flow=out.stereo_flow2[-1:])
        return pose, fr_state, out, torch.stack(poses), success

    @staticmethod
    def _nhwc(limg, rimg, mask, lead):
        """NCHW -> NHWC at the API boundary (``lead`` leading dims)."""
        if limg.shape[-1] not in (1, 3):
            perm = tuple(range(lead)) + (lead + 1, lead + 2, lead)
            limg, rimg = limg.permute(perm), rimg.permute(perm)
        if mask.shape[-1] != 1:
            perm = tuple(range(lead)) + (lead + 1, lead + 2, lead)
            mask = mask.permute(perm)
        return limg, rimg, mask

    @torch.inference_mode()
    def track_window(self, limgs, rimgs, masks, diagnostics=False):
        """Track a window of T frames in one batched pass.

        :param limgs/rimgs: (T, 1, 3, H, W) or (T, 1, H, W, 3)
        :param masks: (T, 1, 1, H, W) or (T, 1, H, W, 1)
        :param diagnostics: also return ``flow`` (T, H, W, 2) and
            ``conf1``/``conf2``/``depth`` (T, H, W, 1), float16
        :return: (poses (T, 1, 7), successes (T,) bool[, diagnostics])
        """
        assert self.frame is not None, "process the first frame via __call__"
        limgs, rimgs, masks = self._nhwc(
            self._tensor(limgs, torch.float32), self._tensor(rimgs, torch.float32),
            self._tensor(masks, torch.bool), 2)
        pose, frame, out, poses, succ = self._window_step(limgs, rimgs, masks)
        self.last_pose, self.frame, self._feats = pose, frame, out.feats
        self.last_solver_iters = out.solver_iters
        self.last_frame = self.frame
        self.success = succ[-1]
        if diagnostics:
            diag = {"flow": out.flow.half(), "conf1": out.conf1.half(),
                    "conf2": out.conf2.half(),
                    "depth": (out.depth2 / self.scale).half()}
            return poses, succ, diag
        return poses, succ

    @torch.inference_mode()
    def __call__(self, limg, rimg, mask):
        """Absolute pose for a new stereo frame.

        :param limg/rimg: (1, 3, H, W) or (1, H, W, 3) in [0, 255]
        :param mask: (1, 1, H, W) or (1, H, W, 1)
        :return: (abs_pose (1, 7), scene (None in f2f), flow (1, H, W, 2),
            (conf1, conf2) (1, H, W, 1)); flow and confidences are None for
            the first frame
        """
        limg, rimg, mask = self._nhwc(
            self._tensor(limg, torch.float32), self._tensor(rimg, torch.float32),
            self._tensor(mask, torch.bool), 1)
        if self.frame is None:
            self.frame, _, self._feats = self._first_step(limg, rimg, mask)
            self.last_frame = None
            self.success = True
            return self.last_pose, self.scene, None, None
        self.last_frame = self.frame
        new_pose, frame, out, success = self._track_step(
            self.last_pose, self.frame, limg, rimg, mask, self._feats)
        self._feats = out.feats
        self.last_pose = new_pose
        self.frame = frame
        self.success = success
        self.last_solver_iters = out.solver_iters
        return self.last_pose, self.scene, out.flow, (out.conf1, out.conf2)
