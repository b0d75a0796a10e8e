"""PoseNet: RAFT flow + TinyUNet confidence heads + LM pose solve with an
implicit-function-theorem backward (port of
``robust_pose_tpu/models/posenet.py``: the inference methods, the
frame-to-model split and the training forward ``__call__``).

NHWC tensors, images in [0, 255]. Config keys: image_shape (H, W), iters,
lbgfs_iters, use_weights, mixed_precision (bf16 convs and correlation
features, f32 parameters), unet_levels, solver_early_exit, lookup and small
(``models.raft``), and for training remat, remat_policy, stop_flow_grad and
dropout (the training ``forward`` takes the dropout masks' generator).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch import nn
from torch.profiler import record_function

from robust_pose_tpu_torch.device import resolve_device
from robust_pose_tpu_torch.models.layers import BatchNorm
from robust_pose_tpu_torch.models.raft import RAFT, SplitConv1x1
from robust_pose_tpu_torch.models.unet import TinyUNet
from robust_pose_tpu_torch.ops.geometry import create_img_coords, depth_to_pcl
from robust_pose_tpu_torch.parallel.mesh import batch_sharding
from robust_pose_tpu_torch.ops.warp import (
    eighth_from_fullres_warp,
    warp_pcl_mask,
    warp_then_eighth,
)
from robust_pose_tpu_torch.solver.gauss_newton import (
    SolverConfig,
    pose_layer,
    solve_pose,
)
from robust_pose_tpu_torch.solver.objectives import PoseProblemInputs

Tensor = torch.Tensor


class PoseNetOutputs(NamedTuple):
    pose: Tensor          # (B, 7)
    pose_tan: Tensor      # (B, 6)
    depth1: Tensor        # (B, H, W, 1)
    depth2: Tensor        # (B, H, W, 1)
    conf1: Tensor         # (B, H, W, 1) 2D confidence
    conf2: Tensor         # (B, H, W, 1) 3D confidence
    flow: Tensor          # (B, H, W, 2) temporal flow
    stereo_flow2: Tensor  # (B, H, W, 2)
    feats: Any = None     # (fmap, net, inp) of image2l for the next call
    solver_iters: Any = None  # (B,) int32 realized LM iterations


class PoseNet(nn.Module):
    def __init__(self, config: dict, device=None):
        super().__init__()
        self.config = dict(config)
        H, W = config["image_shape"]
        mp = config.get("mixed_precision", True)
        dt = torch.bfloat16 if mp else torch.float32
        self.flow = RAFT(iters=config.get("iters", 12), dtype=dt, corr_dtype=dt,
                         lookup=config.get("lookup", "auto"),
                         remat=config.get("remat", False),
                         small=config.get("small", False),
                         dropout=config.get("dropout", 0.0),
                         remat_policy=config.get("remat_policy", "nothing"))
        levels = config.get("unet_levels", 3)
        # the heads read the hidden state and the context beside 8 (2D) or
        # 16 (3D) warped channels: 264 / 272 large, 168 / 176 small (flax
        # infers these widths; the JAX TinyUNet's in_channels is unread)
        feat = self.flow.hdim + self.flow.cdim + 8
        self.weight_head_2d = TinyUNet(feat, (H, W), dt, levels)
        self.weight_head_3d = TinyUNet(feat + 8, (H, W), dt, levels)
        self.loss_weight = nn.Parameter(torch.ones(2))
        self.register_buffer("img_coords", create_img_coords(H, W),
                             persistent=False)
        self.solver_cfg = SolverConfig(
            iters=config.get("lbgfs_iters", 20),
            early_exit=config.get("solver_early_exit", True))
        self.eval()
        self.to(resolve_device(device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Random weights from ``generator``: LeCun-normal conv kernels
        (flax's default), zero biases, identity BatchNorm, unit loss
        weights."""
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, SplitConv1x1)):
                w = m.weight
                fan_in = (w[:, 0] if isinstance(m, nn.ConvTranspose2d)
                          else w[0]).numel()
                w.copy_(torch.randn(w.shape, generator=generator) / fan_in ** 0.5)
                m.bias.zero_()
        self.loss_weight.fill_(1.0)

    # building blocks -----------------------------------------------------

    def run_flow(self, img1, img2, train: bool = False):
        """RAFT pass; returns (flow (B, H, W, 2), hidden (B, H/8, W/8, hdim),
        context (B, H/8, W/8, cdim))."""
        return self.flow(img1, img2, train)

    def flow2depth(self, imagel, imager, baseline):
        """Stereo flow -> normalized depth; returns (depth, valid, flow)."""
        flow, _, _ = self.run_flow(imagel, imager)
        return self.disparity_to_depth(flow, baseline) + (flow,)

    @staticmethod
    def disparity_to_depth(stereo_flow, baseline):
        depth = baseline[:, None, None] / -stereo_flow[..., 0]
        valid = (depth > 0) & (depth <= 1.0)
        depth = torch.where(valid, depth, 1.0)
        return depth[..., None], valid[..., None]

    def get_weight_maps(self, pcl1, depth2, intrinsics, image1l, image2l,
                        mask2, time_flow, stereo_flow1, stereo_flow2, hidden,
                        context, train: bool = False, mesh=None):
        """Warp frame-2 quantities into frame-1 correspondence and predict
        the 2D/3D confidence maps; the point-cloud warp fetches one packed
        channel, the image/stereo-flow channels are warped at the 1/8
        downsample's taps only. ``train`` with ``mesh``: the heads'
        BatchNorm statistics of the global batch."""
        pcl2_w, mask2 = warp_pcl_mask(depth2, mask2, time_flow, intrinsics)
        if self.config.get("use_weights", True):
            inp1 = eighth_from_fullres_warp(
                torch.cat([stereo_flow1, image1l, pcl1], dim=-1))
            five_c = warp_then_eighth(
                torch.cat([stereo_flow2, image2l], dim=-1), time_flow)
            inp2 = torch.cat([five_c, eighth_from_fullres_warp(pcl2_w)], dim=-1)
            feat = torch.cat([inp1, hidden, context], dim=-1)
            conf1 = torch.sigmoid(self.weight_head_2d(feat, train, mesh))
            feat3 = torch.cat([inp1, inp2, hidden, context], dim=-1)
            conf2 = torch.sigmoid(self.weight_head_3d(feat3, train, mesh))
        else:
            conf1 = torch.ones(mask2.shape, dtype=torch.float32,
                               device=mask2.device)
            conf2 = conf1
        return conf1, conf2, pcl2_w, mask2

    def _solve(self, time_flow, pcl1, pcl2, conf1, conf2, mask1, mask2,
               intrinsics):
        """LM solve; differentiable (the implicit-function-theorem pose
        layer) while autograd records."""
        b = time_flow.shape[0]
        xs = PoseProblemInputs(
            flow=time_flow, pcl1=pcl1, pcl2=pcl2, weights1=conf1,
            weights2=conf2, mask1=mask1, mask2=mask2, intrinsics=intrinsics,
            loss_weight=self.loss_weight[None].expand(b, 2))
        if torch.is_grad_enabled():
            return pose_layer(xs, self.solver_cfg)
        return solve_pose(xs, self.solver_cfg)

    # inference -----------------------------------------------------------

    def encode_ref(self, image):
        """(fmap, net, inp) of a reference image: the ``feats`` cache."""
        fmap = self.flow.encode_fnet(image)
        net, inp = self.flow.encode_cnet(image)
        return fmap, net, inp

    def infer(self, image1l, image2l, intrinsics, baseline, depth1, image2r,
              mask1, mask2, stereo_flow1, feats=None) -> PoseNetOutputs:
        """One step: temporal + stereo flow in one RAFT pass, depth, weight
        maps, LM solve. With ``feats`` (the previous call's ``out.feats``)
        image1l is not re-encoded."""
        b = image1l.shape[0]
        if feats is None:
            enc = self.flow.encode_fnet(torch.cat([image1l, image2l, image2r]))
            f1l, f2l, f2r = enc[:b], enc[b:2 * b], enc[2 * b:]
            net_u, inp_u = self.flow.encode_cnet(torch.cat([image1l, image2l]))
            net1l, net2l = net_u[:b], net_u[b:]
            inp1l, inp2l = inp_u[:b], inp_u[b:]
        else:
            f1l, net1l, inp1l = feats
            enc = self.flow.encode_fnet(torch.cat([image2l, image2r]))
            f2l, f2r = enc[:b], enc[b:]
            net2l, inp2l = self.flow.encode_cnet(image2l)

        flows, hidden, context = self.flow.flow_from_features(
            torch.cat([f1l, f2l]), torch.cat([f2l, f2r]),
            torch.cat([net1l, net2l]), torch.cat([inp1l, inp2l]))
        time_flow, stereo_flow2 = flows[:b], flows[b:]
        hidden, context = hidden[:b], context[:b]

        depth2, valid2 = self.disparity_to_depth(stereo_flow2, baseline)
        mask2 = mask2 & valid2
        pcl1 = depth_to_pcl(depth1, intrinsics, self.img_coords)
        conf1, conf2, pcl2, mask2 = self.get_weight_maps(
            pcl1, depth2, intrinsics, image1l, image2l, mask2, time_flow,
            stereo_flow1, stereo_flow2, hidden, context)
        pose, pose_tan, niter = self._solve(
            time_flow, pcl1, pcl2, conf1, conf2, mask1, mask2, intrinsics)
        return PoseNetOutputs(pose, pose_tan, depth1, depth2, conf1, conf2,
                              time_flow, stereo_flow2, (f2l, net2l, inp2l),
                              niter)

    def infer_window(self, limgs, rimgs, masks, intrinsics, baseline,
                     prev_img, prev_depth1, prev_mask, prev_stereo_flow,
                     feats) -> PoseNetOutputs:
        """A window of T frames in one batch-2T RAFT pass (T temporal pairs,
        then T stereo pairs) and one batch-T solve.

        :param limgs/rimgs: (T, H, W, 3); masks (T, H, W, 1) bool
        :param prev_*: the carried reference frame (leading dim 1); depth
            already depth-scale-normalized
        :param feats: (fmap, net, inp) encoder cache of ``prev_img``
        :return: PoseNetOutputs with leading dim T; ``feats`` holds the
            last frame's cache
        """
        t = limgs.shape[0]
        # the profiler spans name the window's four stages (read by
        # chip_smoke.py's profile phase); outside a profiler they cost a
        # few microseconds each
        with record_function("infer_window.encode"):
            enc = self.flow.encode_fnet(torch.cat([limgs, rimgs]))
            fl, fr = enc[:t], enc[t:]
            net_u, inp_u = self.flow.encode_cnet(limgs)
        pf, pnet, pinp = feats
        with record_function("infer_window.flow"):
            flows, hidden, context = self.flow.flow_from_features(
                torch.cat([pf, fl[:-1], fl]), torch.cat([fl, fr]),
                torch.cat([pnet, net_u[:-1], net_u]),
                torch.cat([pinp, inp_u[:-1], inp_u]))
        time_flow, stereo_flow2 = flows[:t], flows[t:]
        hidden, context = hidden[:t], context[:t]

        with record_function("infer_window.weights"):
            depth2, valid2 = self.disparity_to_depth(stereo_flow2,
                                                     baseline.expand(t))
            mask2 = masks & valid2
            image1l = torch.cat([prev_img, limgs[:-1]])
            depth1 = torch.cat([prev_depth1, depth2[:-1]])
            mask1 = torch.cat([prev_mask, masks[:-1]])
            stereo_flow1 = torch.cat([prev_stereo_flow, stereo_flow2[:-1]])
            K = intrinsics.expand(t, 3, 3)
            pcl1 = depth_to_pcl(depth1, K, self.img_coords)
            conf1, conf2, pcl2_w, mask2_w = self.get_weight_maps(
                pcl1, depth2, K, image1l, limgs, mask2, time_flow,
                stereo_flow1, stereo_flow2, hidden, context)
        with record_function("infer_window.solve"):
            pose, pose_tan, niter = self._solve(
                time_flow, pcl1, pcl2_w, conf1, conf2, mask1, mask2_w, K)
        return PoseNetOutputs(pose, pose_tan, depth1, depth2, conf1, conf2,
                              time_flow, stereo_flow2,
                              (fl[-1:], net_u[-1:], inp_u[-1:]), niter)

    # frame-to-model split -------------------------------------------------

    def f2m_precompute(self, limgs, rimgs, masks, baseline):
        """The map-independent part of f2m tracking, batched over T frames:
        the input frames' encoder features and the whole stereo branch
        (stereo flow -> depth -> validity).

        :param limgs/rimgs: (T, H, W, 3); masks (T, H, W, 1) bool
        :param baseline: (1,) pre-scaled stereo baseline
        :return: (fmap_l, net_l, inp_l, stereo_flow2, depth2, mask2), each
            with leading dim T; depth2 normalized, mask2 = masks & valid
        """
        t = limgs.shape[0]
        with record_function("f2m_precompute"):
            enc = self.flow.encode_fnet(torch.cat([limgs, rimgs]))
            fl, fr = enc[:t], enc[t:]
            net_u, inp_u = self.flow.encode_cnet(limgs)
            stereo_flow2, _, _ = self.flow.flow_from_features(fl, fr, net_u, inp_u)
            depth2, valid2 = self.disparity_to_depth(stereo_flow2, baseline.expand(t))
        return fl, net_u, inp_u, stereo_flow2, depth2, masks & valid2

    def f2m_track(self, ref_img, ref_depth1, ref_mask, ref_sflow1, limg, mask2,
                  intrinsics, fmap_l, net_l, inp_l, stereo_flow2,
                  depth2) -> PoseNetOutputs:
        """One f2m tracking step against a rendered reference: only the
        reference is encoded, and RAFT runs the one temporal pair; the same
        math as :meth:`infer` with the stereo quantities precomputed.

        :param ref_*: the rendered model frame: image (1, H, W, 3), depth1
            (1, H, W, 1) already depth-scale-normalized, mask (1, H, W, 1),
            stereo flow (zeros for a rendering)
        :param mask2, fmap_l, ...: this frame's slice of
            :meth:`f2m_precompute` (leading dim 1)
        """
        with record_function("f2m_track.encode"):
            f1 = self.flow.encode_fnet(ref_img)
            net1, inp1 = self.flow.encode_cnet(ref_img)
        with record_function("f2m_track.flow"):
            time_flow, hidden, context = self.flow.flow_from_features(
                f1, fmap_l, net1, inp1)
        with record_function("f2m_track.weights"):
            pcl1 = depth_to_pcl(ref_depth1, intrinsics, self.img_coords)
            conf1, conf2, pcl2_w, mask2_w = self.get_weight_maps(
                pcl1, depth2, intrinsics, ref_img, limg, mask2, time_flow,
                ref_sflow1, stereo_flow2, hidden, context)
        with record_function("f2m_track.solve"):
            pose, pose_tan, niter = self._solve(
                time_flow, pcl1, pcl2_w, conf1, conf2, ref_mask, mask2_w,
                intrinsics)
        return PoseNetOutputs(pose, pose_tan, ref_depth1, depth2, conf1, conf2,
                              time_flow, stereo_flow2, None, niter)

    # training --------------------------------------------------------------

    def forward(self, image1l, image2l, intrinsics, baseline, image1r, image2r,
                mask1=None, mask2=None, train: bool = False,
                dropout_generator=None, mesh=None) -> PoseNetOutputs:
        """The JAX package's training ``__call__``: both stereo pairs and the
        temporal pair in one RAFT pass of 3B pairs, (1l,1r), (2l,2r),
        (1l,2l), with the 4 unique images through fnet and the 2 left ones
        through cnet; depth from the stereo flows, weight maps (``train``:
        batch-statistics BatchNorm in the heads, and the encoders' dropout
        with masks drawn from ``dropout_generator``, fnet's then cnet's), and
        the differentiable pose solve. With ``stop_flow_grad`` RAFT runs
        without autograd (the JAX package's ``stop_gradient`` on the flows,
        hidden state and context). ``mesh`` (``parallel.mesh.Mesh``): this
        call holds one rank's rows of a global batch; the heads' BatchNorm
        takes the global batch's statistics and dropout the global batch's
        masks, as one process on the whole batch would."""
        b = image1l.shape[0]
        fnet_rows = cnet_rows = None
        if mesh is not None:
            # this rank's rows of the global encoder batches: 4 blocks of
            # the global batch through fnet, the first 2 through cnet
            g = b * mesh.world_size
            own = torch.as_tensor(batch_sharding(mesh, g))
            idx = torch.cat([k * g + own for k in range(4)])
            fnet_rows, cnet_rows = (4 * g, idx), (2 * g, idx[:2 * b])
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.config.get("stop_flow_grad", False)):
            enc = self.flow.encode_fnet(torch.cat([image1l, image2l, image1r,
                                                   image2r]), train,
                                        dropout_generator, fnet_rows)
            e1l, e2l = enc[:b], enc[b:2 * b]
            e1r, e2r = enc[2 * b:3 * b], enc[3 * b:]
            net_u, inp_u = self.flow.encode_cnet(torch.cat([image1l, image2l]),
                                                 train, dropout_generator,
                                                 cnet_rows)
            flows, hidden, context = self.flow.flow_from_features(
                torch.cat([e1l, e2l, e1l]), torch.cat([e1r, e2r, e2l]),
                torch.cat([net_u[:b], net_u[b:], net_u[:b]]),
                torch.cat([inp_u[:b], inp_u[b:], inp_u[:b]]))
        stereo_flow1, stereo_flow2 = flows[:b], flows[b:2 * b]
        time_flow = flows[2 * b:]
        hidden, context = hidden[2 * b:], context[2 * b:]

        depth1, valid1 = self.disparity_to_depth(stereo_flow1, baseline)
        depth2, valid2 = self.disparity_to_depth(stereo_flow2, baseline)
        mask1 = valid1 if mask1 is None else mask1 & valid1
        mask2 = valid2 if mask2 is None else mask2 & valid2
        pcl1 = depth_to_pcl(depth1, intrinsics, self.img_coords)
        conf1, conf2, pcl2, mask2 = self.get_weight_maps(
            pcl1, depth2, intrinsics, image1l, image2l, mask2, time_flow,
            stereo_flow1, stereo_flow2, hidden, context, train, mesh)
        pose, pose_tan, niter = self._solve(
            time_flow, pcl1, pcl2, conf1, conf2, mask1, mask2, intrinsics)
        return PoseNetOutputs(pose, pose_tan, depth1, depth2, conf1, conf2,
                              time_flow, stereo_flow2, solver_iters=niter)
