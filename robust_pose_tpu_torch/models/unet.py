"""UNet / TinyUNet confidence heads (port of ``robust_pose_tpu/models/unet.py``).

Keeps the reference quirks: 3x3 convolutions with no padding (VALID),
centre-cropped skips, DownBlock conv->norm->relu->conv vs UpBlock
conv->relu->norm->conv, a 1x1 head in f32 and a final bilinear resize
(half-pixel centres) to the output size. NHWC in and out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from robust_pose_tpu_torch.models.layers import BatchNorm, Conv2d, ConvTranspose2d

Tensor = torch.Tensor


class DownBlock(nn.Module):
    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, 1, 0, dtype)
        self.norm = BatchNorm(cout)
        self.conv2 = Conv2d(cout, cout, 3, 1, 0, dtype)

    def forward(self, x, train: bool = False, mesh=None):
        return self.conv2(F.relu(self.norm(self.conv1(x), train, mesh)))


class UpBlock(nn.Module):
    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, 1, 0, dtype)
        self.norm = BatchNorm(cout)
        self.conv2 = Conv2d(cout, cout, 3, 1, 0, dtype)

    def forward(self, x, train: bool = False, mesh=None):
        return self.conv2(self.norm(F.relu(self.conv1(x)), train, mesh))


def _center_crop(x: Tensor, h: int, w: int) -> Tensor:
    h2, w2 = x.shape[2], x.shape[3]
    dh, dw = (h2 - h) // 2, (w2 - w) // 2
    return x[:, :, dh:h2 - dh, dw:w2 - dw][:, :, :h, :w]


class UNet(nn.Module):
    def __init__(self, enc_chs, dec_chs, out_sz, num_class=1,
                 dtype=torch.float32):
        super().__init__()
        self.enc_chs = tuple(enc_chs)
        self.dec_chs = tuple(dec_chs)
        self.out_sz = tuple(out_sz)
        for i in range(len(enc_chs) - 1):
            setattr(self, f"enc{i}", DownBlock(enc_chs[i], enc_chs[i + 1], dtype))
        for i in range(len(dec_chs) - 1):
            setattr(self, f"upconv{i}",
                    ConvTranspose2d(dec_chs[i], dec_chs[i + 1], 2, 2, dtype))
            setattr(self, f"dec{i}", UpBlock(dec_chs[i], dec_chs[i + 1], dtype))
        self.head = Conv2d(dec_chs[-1], num_class, 1, 1, 0, torch.float32)

    def forward(self, x: Tensor, train: bool = False, mesh=None) -> Tensor:
        """``train``: the blocks' BatchNorms use and update batch
        statistics (flax ``use_running_average=not train``), those of the
        global batch under ``mesh`` (``layers.BatchNorm``)."""
        x = x.permute(0, 3, 1, 2)
        feats = []
        n_enc = len(self.enc_chs) - 1
        for i in range(n_enc):
            x = getattr(self, f"enc{i}")(x, train, mesh)
            feats.append(x)
            if i < n_enc - 1:
                x = F.max_pool2d(x, 2, 2)
        feats = feats[::-1]
        x = feats[0]
        for i in range(len(self.dec_chs) - 1):
            x = getattr(self, f"upconv{i}")(x)
            skip = _center_crop(feats[i + 1], x.shape[2], x.shape[3])
            x = getattr(self, f"dec{i}")(torch.cat([x, skip.to(x.dtype)], dim=1),
                                         train, mesh)
        x = self.head(x.float())
        x = F.interpolate(x, size=self.out_sz, mode="bilinear",
                          align_corners=False)
        return x.permute(0, 2, 3, 1)


class TinyUNet(nn.Module):
    """enc (in, 16, 32, 64), dec (64, 32, 16), truncated to ``levels``."""

    def __init__(self, in_channels, output_size, dtype=torch.float32, levels=3):
        super().__init__()
        enc = (in_channels, 16, 32, 64)[: levels + 1]
        self.unet = UNet(enc, tuple(reversed(enc[1:])), output_size, dtype=dtype)

    def forward(self, x: Tensor, train: bool = False, mesh=None) -> Tensor:
        return self.unet(x, train, mesh)
