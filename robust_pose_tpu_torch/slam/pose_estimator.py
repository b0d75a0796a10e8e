"""Stereo camera pose estimator, frame-to-frame and frame-to-model (port of
``robust_pose_tpu/slam/pose_estimator.py``).

A solved relative pose that is non-finite or has |log| > 0.1 is replaced by
the identity (``_rel_check``); absolute poses chain as ``last * rel^-1``.

Frame-to-model (``frame2frame: False``, ``configuration/infer_scared.yaml``)
tracks each frame against a rendering of the surfel map
(``slam.surfel_map``) and fuses it on success. The rendering the next step
needs (at the inverse of the pose just solved) is made right after the
fuse and carried, as in the JAX package. Where the JAX step chooses with
``lax.cond(success, fuse, identity)``, the port reads the success flag on
the host and branches with ``if``. On the card this read is the f2m
step's only host sync: the LM solve is one kernel launch with no sync.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from robust_pose_tpu_torch import se3
from robust_pose_tpu_torch.device import resolve_device
from robust_pose_tpu_torch.models.posenet import PoseNet
from robust_pose_tpu_torch.slam.frame import Frame, make_frame
from robust_pose_tpu_torch.slam.surfel_map import (
    SurfelMap,
    surfel_fuse,
    surfel_fuse_render,
    surfel_render,
)

Tensor = torch.Tensor


class PoseEstimator:
    """:param config: SLAM config (frame2frame, depth_clipping,
        conf_weighing, lbgfs_iters; for f2m also dist_thr, average_pts,
        map_capacity, and optionally exact_render, winner, initial_bucket,
        upscale; configuration/infer_f2f.yaml, infer_scared.yaml)
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
        self.device = resolve_device(device)
        model_config = dict(checkpoint["config"]["model"])
        model_config["image_shape"] = (img_shape[1], img_shape[0])
        model_config["lbgfs_iters"] = config["lbgfs_iters"]
        model_config["use_weights"] = config["conf_weighing"]
        self.config = config
        self.model_config = model_config
        self.model = PoseNet(model_config, device=self.device)
        self._load_weights(checkpoint["state_dict"])

        self.intrinsics = torch.as_tensor(
            np.asarray(intrinsics, np.float32), device=self.device)[None]
        self.scale = float(1.0 / config["depth_clipping"][1])
        self.baseline = torch.tensor([baseline], dtype=torch.float32,
                                     device=self.device)
        self.frame2frame = config.get("frame2frame", True)
        self.last_pose = (se3.identity((1,), device=self.device)
                          if init_pose is None else
                          self._tensor(init_pose, torch.float32).reshape(1, 7))
        self.last_frame: Optional[Frame] = None
        self.frame: Optional[Frame] = None
        self.scene: Optional[SurfelMap] = None
        self.success = True
        self._feats = None
        self._model_frame: Optional[Frame] = None   # carried f2m reference
        self.last_solver_iters = None

    def _load_weights(self, state_dict):
        """Load the checkpoint's weights; without confidence weighting the
        weight heads never run, and a checkpoint may lack them (a JAX
        model built with ``use_weights: False`` has none), as flax needs
        no parameters for a module it does not call."""
        missing, unexpected = self.model.load_state_dict(state_dict, strict=False)
        if not self.model_config["use_weights"]:
            missing = [k for k in missing if not k.startswith("weight_head_")]
        if missing or unexpected:
            raise RuntimeError(f"checkpoint: missing {missing[:8]}, "
                               f"unexpected {unexpected[:8]}")

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

    # frame-to-model ---------------------------------------------------------

    def _fuse_and_render(self, state, frame, pose, cfg):
        """(state after fusing ``frame`` at ``pose``, the rendering at
        ``inv(pose)``): one pool pass when ``average_pts`` is off and
        ``upscale`` is 1, else a fuse and a render."""
        kmat = self.intrinsics[0]
        with record_function("fuse_render"):
            if not cfg.average_pts and cfg.upscale == 1:
                return surfel_fuse_render(state, frame, pose, kmat, cfg)
            state = surfel_fuse(state, frame, pose, kmat, cfg)
            return state, surfel_render(state, kmat, cfg, extrinsics=se3.inv(pose))

    def _f2m_step(self, last_pose, state, model_frame, limg, rimg, mask, pre,
                  cfg):
        """Track one frame against the carried model frame, then fuse it and
        render the next reference (or, on failure, keep the pool; the
        rendering is redone only when the fuse and render are separate, as
        in the JAX step). ``pre`` is the frame's ``f2m_precompute`` slice.

        :return: (new_pose, frame, out, success (0-d bool), new_state,
            new_model_frame)
        """
        f_l, n_l, i_l, sf2, d2, m2 = pre
        out = self.model.f2m_track(
            model_frame.img, model_frame.depth * self.scale, model_frame.mask,
            torch.zeros_like(model_frame.flow), limg, m2, self.intrinsics,
            f_l, n_l, i_l, sf2, d2)
        rel, ok = self._rel_check(out.pose)
        success = ok[0]
        new_pose = se3.normalize(se3.mul(last_pose, se3.inv(rel)))
        frame = make_frame(limg, rimg, depth=d2 / self.scale, mask=mask,
                           flow=sf2)
        merged = not cfg.average_pts and cfg.upscale == 1
        if bool(success):
            new_state, new_mf = self._fuse_and_render(state, frame, new_pose[0], cfg)
        elif merged:
            new_state, new_mf = state, model_frame
        else:
            new_state = state
            new_mf = surfel_render(state, self.intrinsics[0], cfg,
                                   extrinsics=se3.inv(new_pose[0]))
        return new_pose, frame, out, success, new_state, new_mf

    def _model_frame_f2m(self) -> Frame:
        """The carried f2m reference; rendered fresh only right after the
        scene was made."""
        if self._model_frame is None:
            self._model_frame = surfel_render(
                self.scene.state, self.intrinsics[0], self.scene.cfg,
                se3.inv(self.last_pose[0]))
        return self._model_frame

    def _init_scene(self, frame: Frame):
        """The surfel map of the first frame (pixels with valid depth)."""
        cfg = self.config
        self.scene = SurfelMap(
            frame, self.intrinsics[0],
            config={"dist_thr": cfg.get("dist_thr", 0.05),
                    "average_pts": cfg.get("average_pts", True),
                    # the JAX estimator's f2m defaults: the packed-key
                    # winner by the double-sort pipeline
                    "exact_render": cfg.get("exact_render", False),
                    "winner": cfg.get("winner", "segsort"),
                    "initial_bucket": cfg.get("initial_bucket"),
                    "upscale": cfg.get("upscale", 1)},
            pmat=self.last_pose[0],
            capacity=cfg.get("map_capacity"))

    def _track_f2m(self, limg, rimg, mask):
        """The per-frame f2m step with its pool maintenance: on a bucket
        overflow the fuse and the next rendering are re-run from the
        pre-fuse state (the pose was solved before the fuse)."""
        cfg = self.scene.cfg
        pre = self.model.f2m_precompute(limg, rimg, mask, self.baseline * self.scale)
        prev_state = self.scene.state
        new_pose, frame, out, success, new_state, new_mf = self._f2m_step(
            self.last_pose, prev_state, self._model_frame_f2m(), limg, rimg,
            mask, pre, cfg)
        model_frame = self._model_frame
        self.scene.state = new_state
        self._model_frame = new_mf

        def redo(st, cfg):
            st2, self._model_frame = self._fuse_and_render(st, frame, new_pose[0], cfg)
            return st2

        self.scene.post_fuse(prev_state, redo)
        # the rendered model frame stays inspectable with its confidences
        self.last_frame = dataclasses.replace(
            model_frame, rimg=self.frame.rimg, confidence=out.conf1)
        return new_pose, frame, out, success

    def _track_window_f2m(self, limgs, rimgs, masks, diagnostics=False):
        """f2m over a window: one batched ``f2m_precompute`` over its T
        frames, then a loop over frames carrying (pose, surfel state, model
        frame). If the pool overflowed its bucket, the loop is re-run from
        the pre-window carries at the grown bucket."""
        pre = self.model.f2m_precompute(limgs[:, 0], rimgs[:, 0], masks[:, 0],
                                        self.baseline * self.scale)
        pre_mf = self._model_frame_f2m()
        pre_pose, pre_state = self.last_pose, self.scene.state
        result = {}

        def run(state, cfg):
            pose, mf = pre_pose, pre_mf
            poses, succ, niter, diag = [], [], [], []
            for t in range(limgs.shape[0]):
                pose, _, out, ok, state, mf = self._f2m_step(
                    pose, state, mf, limgs[t], rimgs[t], masks[t],
                    [p[t:t + 1] for p in pre], cfg)
                poses.append(pose)
                succ.append(ok)
                niter.append(out.solver_iters)
                if diagnostics:
                    diag.append((out.flow[0].half(), out.conf1[0].half(),
                                 out.conf2[0].half()))
            self.last_pose, self._model_frame = pose, mf
            result.update(poses=torch.stack(poses), succ=torch.stack(succ),
                          niter=torch.stack(niter), diag=diag)
            return state

        self.scene.state = run(self.scene.state, self.scene.cfg)
        self.scene.post_fuse(pre_state, run, frames=limgs.shape[0])
        depth2, sflow2 = pre[4], pre[3]
        self.frame = make_frame(limgs[-1], rimgs[-1],
                                depth=depth2[-1:] / self.scale,
                                mask=masks[-1], flow=sflow2[-1:])
        self.last_frame = self.frame
        self.last_solver_iters = result["niter"]
        self.success = result["succ"][-1]
        if diagnostics:
            flow, conf1, conf2 = (torch.stack(x) for x in zip(*result["diag"]))
            return result["poses"], result["succ"], {
                "flow": flow, "conf1": conf1, "conf2": conf2,
                "depth": (depth2 / self.scale).half()}
        return result["poses"], result["succ"]

    # host API ---------------------------------------------------------------

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
        """Track a window of T frames: f2f in one batched pass, f2m as one
        batched precompute and a loop over frames.

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
        if not self.frame2frame:
            return self._track_window_f2m(limgs, rimgs, masks, diagnostics)
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
        :return: (abs_pose (1, 7), scene (the SurfelMap in f2m, else None),
            flow (1, H, W, 2), (conf1, conf2) (1, H, W, 1)); flow and
            confidences are None for the first frame
        """
        limg, rimg, mask = self._nhwc(
            self._tensor(limg, torch.float32), self._tensor(rimg, torch.float32),
            self._tensor(mask, torch.bool), 1)
        if self.frame is None:
            self.frame, valid, self._feats = self._first_step(limg, rimg, mask)
            self.last_frame = None
            self.success = True
            if not self.frame2frame:
                # the map starts from the pixels with valid stereo depth
                self._init_scene(dataclasses.replace(self.frame,
                                                     mask=self.frame.mask & valid))
            return self.last_pose, self.scene, None, None
        if self.frame2frame:
            self.last_frame = self.frame
            new_pose, frame, out, success = self._track_step(
                self.last_pose, self.frame, limg, rimg, mask, self._feats)
            self._feats = out.feats
        else:
            new_pose, frame, out, success = self._track_f2m(limg, rimg, mask)
        self.last_pose = new_pose
        self.frame = frame
        self.success = success
        self.last_solver_iters = out.solver_iters
        return self.last_pose, self.scene, out.flow, (out.conf1, out.conf2)

    def get_last_frame(self):
        return self.last_frame

    def get_frame(self):
        return self.frame

    @property
    def pose_numpy(self) -> np.ndarray:
        return self.last_pose[0].cpu().numpy()
