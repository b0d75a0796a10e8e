"""Frame container (port of ``robust_pose_tpu/slam/frame.py``): a plain
dataclass of NHWC tensors."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

Tensor = torch.Tensor


@dataclass
class Frame:
    img: Tensor         # (B, H, W, 3) left RGB in [0, 255]
    rimg: Tensor        # (B, H, W, 3) right RGB
    depth: Tensor       # (B, H, W, 1)
    mask: Tensor        # (B, H, W, 1) bool
    confidence: Tensor  # (B, H, W, 1)
    flow: Tensor        # (B, H, W, 2) left->right stereo flow


def make_frame(img: Tensor, rimg: Optional[Tensor] = None,
               depth: Optional[Tensor] = None, mask: Optional[Tensor] = None,
               confidence: Optional[Tensor] = None,
               flow: Optional[Tensor] = None) -> Frame:
    b, h, w, _ = img.shape
    kw = dict(dtype=torch.float32, device=img.device)
    return Frame(
        img=img,
        rimg=img if rimg is None else rimg,
        depth=torch.ones((b, h, w, 1), **kw) if depth is None else depth,
        mask=(torch.ones((b, h, w, 1), dtype=torch.bool, device=img.device)
              if mask is None else mask.bool()),
        confidence=(torch.ones((b, h, w, 1), **kw)
                    if confidence is None else confidence),
        flow=torch.zeros((b, h, w, 2), **kw) if flow is None else flow,
    )
