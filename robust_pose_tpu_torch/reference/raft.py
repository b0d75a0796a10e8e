"""Full PyTorch RAFT (upstream princeton-vl architecture, aimi-lab fork API)
for the end-to-end parity oracle.

Re-implemented from the architecture pinned down in SURVEY.md §2.9 (reference
imports ``core.RAFT.core.raft.RAFT`` — an empty submodule in the snapshot —
at the reference's core/pose/pose_net.py:6 and consumes
``forward(img1, img2) -> (flow_predictions, gru_hidden, context)`` at
pose_net.py:47,63-69). State-dict key names match the reference checkpoints
(``fnet/cnet/update_block`` prefixes) so ``utils/torch_convert`` maps them.

Faithful upstream quirks preserved on purpose:
* the correlation window is sampled with ``delta = meshgrid(dy, dx)`` whose
  FIRST component displaces X — so the per-level 81 window channels are
  x-offset-major (the JAX rebuild's lookup is y-offset-major; the converter
  transposes the convc1 rows — see torch_convert._permute_corr_window).
* ``coords1.detach()`` per iteration, zeros-padded bilinear sampling with
  align_corners=True.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class ResidualBlock(nn.Module):
    def __init__(self, in_planes, planes, norm_fn="instance", stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.relu = nn.ReLU(inplace=True)
        mk = (nn.InstanceNorm2d if norm_fn == "instance" else nn.BatchNorm2d)
        self.norm1 = mk(planes)
        self.norm2 = mk(planes)
        if stride == 1 and in_planes == planes:
            self.downsample = None
        else:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride), mk(planes))

    def forward(self, x):
        y = self.relu(self.norm1(self.conv1(x)))
        y = self.relu(self.norm2(self.conv2(y)))
        x = x if self.downsample is None else self.downsample(x)
        return self.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, output_dim=256, norm_fn="instance"):
        super().__init__()
        self.norm1 = (nn.InstanceNorm2d(64) if norm_fn == "instance"
                      else nn.BatchNorm2d(64))
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.relu1 = nn.ReLU(inplace=True)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, norm_fn, 1),
                                    ResidualBlock(64, 64, norm_fn, 1))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, norm_fn, 2),
                                    ResidualBlock(96, 96, norm_fn, 1))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, norm_fn, 2),
                                    ResidualBlock(128, 128, norm_fn, 1))
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x):
        x = self.relu1(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_levels=4, corr_radius=4):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.convc1 = nn.Conv2d(cor_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc1(corr))
        cor = F.relu(self.convc2(cor))
        flo = F.relu(self.convf1(flow))
        flo = F.relu(self.convf2(flo))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim=128, input_dim=256):
        super().__init__()
        hd = hidden_dim
        self.convz1 = nn.Conv2d(hd + input_dim, hd, (1, 5), padding=(0, 2))
        self.convr1 = nn.Conv2d(hd + input_dim, hd, (1, 5), padding=(0, 2))
        self.convq1 = nn.Conv2d(hd + input_dim, hd, (1, 5), padding=(0, 2))
        self.convz2 = nn.Conv2d(hd + input_dim, hd, (5, 1), padding=(2, 0))
        self.convr2 = nn.Conv2d(hd + input_dim, hd, (5, 1), padding=(2, 0))
        self.convq2 = nn.Conv2d(hd + input_dim, hd, (5, 1), padding=(2, 0))

    def forward(self, h, x):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz1(hx))
        r = torch.sigmoid(self.convr1(hx))
        q = torch.tanh(self.convq1(torch.cat([r * h, x], dim=1)))
        h = (1 - z) * h + z * q
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz2(hx))
        r = torch.sigmoid(self.convr2(hx))
        q = torch.tanh(self.convq2(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


class FlowHead(nn.Module):
    def __init__(self, input_dim=128, hidden_dim=256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x):
        return self.conv2(self.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = BasicMotionEncoder()
        self.gru = SepConvGRU(hidden_dim=128, input_dim=128 + 128)
        self.flow_head = FlowHead(128, 256)
        self.mask = nn.Sequential(
            nn.Conv2d(128, 256, 3, padding=1), nn.ReLU(inplace=True),
            nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        inp = torch.cat([inp, motion], dim=1)
        net = self.gru(net, inp)
        delta_flow = self.flow_head(net)
        up_mask = 0.25 * self.mask(net)
        return net, up_mask, delta_flow


def coords_grid(batch, ht, wd):
    coords = torch.meshgrid(torch.arange(ht), torch.arange(wd),
                            indexing="ij")
    coords = torch.stack(coords[::-1], dim=0).float()
    return coords[None].repeat(batch, 1, 1, 1)


def bilinear_sampler(img, coords):
    """Zeros-padded grid_sample with align_corners=True (upstream utils)."""
    H, W = img.shape[-2:]
    xgrid, ygrid = coords.split([1, 1], dim=-1)
    xgrid = 2 * xgrid / (W - 1) - 1
    ygrid = 2 * ygrid / (H - 1) - 1
    grid = torch.cat([xgrid, ygrid], dim=-1)
    return F.grid_sample(img, grid, align_corners=True)


class CorrBlock:
    def __init__(self, fmap1, fmap2, num_levels=4, radius=4):
        self.num_levels = num_levels
        self.radius = radius
        b, c, h, w = fmap1.shape
        f1 = fmap1.view(b, c, h * w)
        f2 = fmap2.view(b, c, h * w)
        corr = torch.matmul(f1.transpose(1, 2), f2)
        corr = corr.view(b * h * w, 1, h, w) / torch.sqrt(
            torch.tensor(c, dtype=torch.float32))
        self.pyramid = [corr]
        for _ in range(num_levels - 1):
            corr = F.avg_pool2d(corr, 2, stride=2)
            self.pyramid.append(corr)
        self.shape = (b, h, w)

    def __call__(self, coords):
        r = self.radius
        coords = coords.permute(0, 2, 3, 1)
        b, h, w, _ = coords.shape
        out_pyramid = []
        for i in range(self.num_levels):
            corr = self.pyramid[i]
            dx = torch.linspace(-r, r, 2 * r + 1)
            dy = torch.linspace(-r, r, 2 * r + 1)
            # upstream quirk: meshgrid(dy, dx) — the first (row) window axis
            # displaces X in bilinear_sampler's (x, y) coords split
            delta = torch.stack(torch.meshgrid(dy, dx, indexing="ij"),
                                dim=-1)
            centroid = coords.reshape(b * h * w, 1, 1, 2) / 2 ** i
            delta_lvl = delta.view(1, 2 * r + 1, 2 * r + 1, 2)
            coords_lvl = centroid + delta_lvl
            corr = bilinear_sampler(corr, coords_lvl)
            out_pyramid.append(corr.view(b, h, w, -1))
        out = torch.cat(out_pyramid, dim=-1)
        return out.permute(0, 3, 1, 2).contiguous().float()


class RAFT(nn.Module):
    """aimi-lab fork API: forward -> (flow_predictions, net, inp)."""

    def __init__(self, iters=12):
        super().__init__()
        self.iters = iters
        self.hdim = self.cdim = 128
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(self.hdim + self.cdim, "batch")
        self.update_block = BasicUpdateBlock()

    def freeze_bn(self):
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.eval()

    @staticmethod
    def upsample_flow(flow, mask):
        N, _, H, W = flow.shape
        mask = mask.view(N, 1, 9, 8, 8, H, W)
        mask = torch.softmax(mask, dim=2)
        up_flow = F.unfold(8 * flow, (3, 3), padding=1)
        up_flow = up_flow.view(N, 2, 9, 1, 1, H, W)
        up_flow = torch.sum(mask * up_flow, dim=2)
        up_flow = up_flow.permute(0, 1, 4, 2, 5, 3)
        return up_flow.reshape(N, 2, 8 * H, 8 * W)

    def forward(self, image1, image2, upsample=True):
        image1 = 2 * (image1 / 255.0) - 1.0
        image2 = 2 * (image2 / 255.0) - 1.0
        fmaps = self.fnet(torch.cat([image1, image2], dim=0))
        fmap1, fmap2 = fmaps[:image1.shape[0]], fmaps[image1.shape[0]:]
        corr_fn = CorrBlock(fmap1, fmap2)
        c = self.cnet(image1)
        net, inp = torch.split(c, [self.hdim, self.cdim], dim=1)
        net = torch.tanh(net)
        inp = torch.relu(inp)

        b, _, h, w = image1.shape
        coords0 = coords_grid(b, h // 8, w // 8)
        coords1 = coords_grid(b, h // 8, w // 8)

        predictions = []
        for _ in range(self.iters):
            coords1 = coords1.detach()
            corr = corr_fn(coords1)
            flow = coords1 - coords0
            net, up_mask, delta = self.update_block(net, inp, corr, flow)
            coords1 = coords1 + delta
            predictions.append(self.upsample_flow(coords1 - coords0, up_mask))
        return predictions, net, inp
