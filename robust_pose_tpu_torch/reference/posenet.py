"""Full PyTorch PoseNet for the end-to-end parity oracle.

Re-implements the reference model exactly as documented in SURVEY.md:
the reference's core/pose/pose_net.py:13-164 (flow2depth, proj,
get_weight_maps, batched infer), core/pose/pose_head.py:5-79 (weighted 2D
reprojection + 3D point-to-point objectives, float64 LBFGS solve), and
core/unet/unet.py:7-82 (TinyUNet heads). lietorch is replaced by
robust_pose_tpu_torch/reference/se3.py. State-dict key names match the reference checkpoints
(``flow.``, ``weight_head_2d.0.``, ``weight_head_3d.0.``, ``loss_weight``).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from robust_pose_tpu_torch.reference import se3
from robust_pose_tpu_torch.reference.raft import RAFT


# --------------------------------------------------------------------------
# TinyUNet (reference core/unet/unet.py:7-82)
# --------------------------------------------------------------------------

class DownBlock(nn.Module):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3)
        self.norm = nn.BatchNorm2d(out_ch)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3)

    def forward(self, x):
        return self.conv2(self.relu(self.norm(self.conv1(x))))


class UpBlock(DownBlock):
    def forward(self, x):
        return self.conv2(self.norm(self.relu(self.conv1(x))))


class Encoder(nn.Module):
    def __init__(self, chs):
        super().__init__()
        self.enc_blocks = nn.ModuleList(
            [DownBlock(chs[i], chs[i + 1]) for i in range(len(chs) - 1)])
        self.pool = nn.MaxPool2d(2)

    def forward(self, x):
        ftrs = []
        for block in self.enc_blocks:
            x = block(x)
            ftrs.append(x)
            x = self.pool(x)
        return ftrs


class Decoder(nn.Module):
    def __init__(self, chs):
        super().__init__()
        self.chs = chs
        self.upconvs = nn.ModuleList(
            [nn.ConvTranspose2d(chs[i], chs[i + 1], 2, 2)
             for i in range(len(chs) - 1)])
        self.dec_blocks = nn.ModuleList(
            [UpBlock(chs[i], chs[i + 1]) for i in range(len(chs) - 1)])

    def forward(self, x, encoder_features):
        for i in range(len(self.chs) - 1):
            x = self.upconvs[i](x)
            enc = encoder_features[i]
            H2, W2 = enc.shape[-2:]
            H, W = x.shape[-2:]
            dh, dw = (H2 - H) // 2, (W2 - W) // 2
            enc = enc[..., dh:(H2 - dh), dw:(W2 - dw)][..., :H, :W]
            x = torch.cat([x, enc], dim=1)
            x = self.dec_blocks[i](x)
        return x


class TinyUNet(nn.Module):
    def __init__(self, in_channels, output_size):
        super().__init__()
        enc_chs = (in_channels, 16, 32, 64)
        dec_chs = (64, 32, 16)
        self.encoder = Encoder(enc_chs)
        self.decoder = Decoder(dec_chs)
        self.head = nn.Conv2d(dec_chs[-1], 1, 1)
        self.out_sz = tuple(output_size)

    def forward(self, x):
        f = self.encoder(x)
        out = self.decoder(f[::-1][0], f[::-1][1:])
        return F.interpolate(self.head(out), self.out_sz, mode="bilinear")


# --------------------------------------------------------------------------
# geometry + warps (reference pinhole_transforms.py / flow_utils.py)
# --------------------------------------------------------------------------

def create_img_coords(h, w, dtype=torch.float32):
    ys = torch.arange(h, dtype=dtype) + 0.5
    xs = torch.arange(w, dtype=dtype) + 0.5
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xg.reshape(-1), yg.reshape(-1),
                        torch.ones(h * w, dtype=dtype)], dim=0)  # (3, N)


def project(opts, K, pose=None):
    """opts (B, 3, N) -> pixel homogeneous (B, 3, N)."""
    if pose is not None:
        opts = se3.act(pose[:, None], opts.transpose(1, 2)).transpose(1, 2)
    ipts = torch.bmm(K, opts)
    z = ipts[:, -1:].clamp(min=1e-12)
    return torch.cat([ipts[:, :2] / z, torch.ones_like(z)], dim=1)


def remap_from_flow(x, flow, mode="bilinear"):
    """(reference core/interpol/flow_utils.py:4-26)."""
    b, _, h, w = flow.shape
    yg, xg = torch.meshgrid(torch.arange(h, dtype=flow.dtype),
                            torch.arange(w, dtype=flow.dtype), indexing="ij")
    cx = xg[None] + flow[:, 0]
    cy = yg[None] + flow[:, 1]
    gx = 2 * cx / (w - 1) - 1
    gy = 2 * cy / (h - 1) - 1
    grid = torch.stack([gx, gy], dim=-1)
    out = F.grid_sample(x, grid, mode=mode, align_corners=True)
    valid = torch.any(out > 0, dim=1, keepdim=True)
    return out, valid


# --------------------------------------------------------------------------
# pose head (reference core/pose/pose_head.py:5-79)
# --------------------------------------------------------------------------

class DPoseSE3Head:
    def __init__(self, img_coords, lbgfs_iters=20):
        self.img_coords = img_coords  # (3, N)
        self.lbgfs_iters = lbgfs_iters

    def reprojection_objective(self, flow, pcl1, w1, m1, K, pose, h, w):
        b = flow.shape[0]
        warped = project(pcl1.reshape(b, 3, -1), K, pose)[:, :2]
        flow_off = self.img_coords[None, :2].to(flow) + flow.reshape(b, 2, -1)
        res = torch.sum((flow_off - warped) ** 2, dim=1) * w1.reshape(b, -1)
        valid = ((flow_off[:, 0] > 0) & (flow_off[:, 1] > 0)
                 & (flow_off[:, 0] < w) & (flow_off[:, 1] < h)
                 & m1.reshape(b, -1) & torch.isfinite(res))
        res = torch.where(valid, res, torch.zeros_like(res))
        return res.mean(dim=1) / (h * w)

    def depth_objective(self, pcl1, pcl2, w2, m1, m2, pose):
        b = pcl1.shape[0]
        p1 = se3.act(pose[:, None], pcl1.reshape(b, 3, -1).transpose(1, 2))
        res = torch.sum((p1.transpose(1, 2) - pcl2.reshape(b, 3, -1)) ** 2,
                        dim=1) * w2.reshape(b, -1)
        valid = (m1 & m2).reshape(b, -1)
        res = torch.where(valid, res, torch.zeros_like(res))
        return res.mean(dim=-1)

    def objective(self, xs, pose, h, w):
        flow, pcl1, pcl2, w1, w2, m1, m2, K, lw = xs
        l3d = self.depth_objective(pcl1, pcl2, w2, m1, m2, pose)
        l2d = self.reprojection_objective(flow, pcl1, w1, m1, K, pose, h, w)
        return lw[:, 1] * l2d + lw[:, 0] * l3d

    def solve(self, xs):
        """float64 LBFGS from identity (reference pose_head.py:60-79).

        The inner optimization runs under enable_grad even when the caller is
        in inference mode (ddn DeclarativeFunction pattern)."""
        h, w = xs[0].shape[-2:]
        xs64 = [x.detach().double() if torch.is_floating_point(x) else x
                for x in xs]
        b = xs[0].shape[0]
        eps = torch.zeros(b, 6, dtype=torch.float64, requires_grad=True)
        opt = torch.optim.LBFGS([eps], lr=1.0, max_iter=self.lbgfs_iters,
                                line_search_fn=None)

        def closure():
            opt.zero_grad()
            loss = self.objective(xs64, se3.exp(eps), h, w).sum()
            loss.backward()
            torch.nn.utils.clip_grad_norm_([eps], 10.0)
            return loss

        with torch.enable_grad():
            opt.step(closure)
        pose = se3.exp(eps.detach())
        return pose.float(), se3.log(pose).float()


# --------------------------------------------------------------------------
# PoseNet (reference core/pose/pose_net.py:13-164)
# --------------------------------------------------------------------------

class PoseNet(nn.Module):
    def __init__(self, config):
        super().__init__()
        H, W = config["image_shape"]
        self.config = config
        self.flow = RAFT(iters=config.get("iters", 12))
        self.weight_head_2d = nn.Sequential(
            TinyUNet(128 + 128 + 8, (H, W)), nn.Sigmoid())
        self.weight_head_3d = nn.Sequential(
            TinyUNet(128 + 128 + 16, (H, W)), nn.Sigmoid())
        self.loss_weight = nn.Parameter(torch.ones(2))
        self.img_coords = create_img_coords(H, W)
        self.pose_head = DPoseSE3Head(self.img_coords,
                                      config.get("lbgfs_iters", 20))

    def proj(self, depth, K):
        b, _, h, w = depth.shape
        rays = torch.linalg.inv(K) @ self.img_coords.to(depth)[None]
        return (depth.reshape(b, 1, -1) * rays).reshape(b, 3, h, w)

    @staticmethod
    def flow2depth_from(stereo_flow, baseline):
        depth = baseline[:, None, None] / -stereo_flow[:, 0]
        valid = (depth > 0) & (depth <= 1.0)
        depth = torch.where(valid, depth, torch.ones_like(depth))
        return depth[:, None], valid[:, None]

    def flow2depth(self, imagel, imager, baseline):
        flows, _, _ = self.flow(imagel, imager)
        flow = flows[-1]
        depth, valid = self.flow2depth_from(flow, baseline)
        return depth, valid, flow

    def get_weight_maps(self, pcl1, pcl2, img1, img2, mask2, flow,
                        sflow1, sflow2):
        pcl2w, _ = remap_from_flow(pcl2, flow)
        img2w, _ = remap_from_flow(img2, flow)
        sflow2w, _ = remap_from_flow(sflow2, flow)
        m2f, valid_map = remap_from_flow(mask2.float(), flow, mode="nearest")
        mask2 = valid_map & (m2f > 0)
        if self.config.get("use_weights", True):
            inp1 = F.interpolate(torch.cat([sflow1, img1, pcl1], dim=1),
                                 scale_factor=0.125, mode="bilinear")
            inp2 = F.interpolate(torch.cat([sflow2w, img2w, pcl2w], dim=1),
                                 scale_factor=0.125, mode="bilinear")
            conf1 = self.weight_head_2d(
                torch.cat([inp1, self.hidden, self.context], dim=1))
            conf2 = self.weight_head_3d(
                torch.cat([inp1, inp2, self.hidden, self.context], dim=1))
        else:
            conf1 = torch.ones_like(mask2, dtype=torch.float32)
            conf2 = torch.ones_like(mask2, dtype=torch.float32)
        return conf1, conf2, pcl2w, mask2

    @torch.no_grad()
    def infer(self, img1, img2, K, baseline, depth1, img2r, mask1, mask2,
              sflow1):
        """(reference core/pose/pose_net.py:60-85)."""
        b = img1.shape[0]
        flows, net, inp = self.flow(torch.cat([img1, img2], dim=0),
                                    torch.cat([img2, img2r], dim=0))
        flow_all = flows[-1]
        flow, sflow2 = flow_all[:b], flow_all[b:]
        self.hidden, self.context = net[:b], inp[:b]

        depth2, valid2 = self.flow2depth_from(sflow2, baseline)
        mask2 = mask2 & valid2
        pcl1 = self.proj(depth1, K)
        pcl2 = self.proj(depth2, K)
        conf1, conf2, pcl2w, mask2w = self.get_weight_maps(
            pcl1, pcl2, img1, img2, mask2, flow, sflow1, sflow2)
        pose, pose_tan = self.pose_head.solve(
            (flow, pcl1, pcl2w, conf1, conf2, mask1, mask2w, K,
             self.loss_weight[None].expand(b, -1)))
        return pose, pose_tan, depth2, conf1, conf2, flow, sflow2
