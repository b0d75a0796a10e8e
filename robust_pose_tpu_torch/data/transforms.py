"""Host-side image transforms (port of ``robust_pose_tpu/data/transforms.py``):
numpy / cv2 on HWC arrays. cv2 is imported where it resizes, so the module
imports without it (``DevicePreproc`` does the same work on the device).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class Compose:
    def __init__(self, transforms: List):
        self.transforms = transforms

    def __call__(self, *args):
        for tr in self.transforms:
            args = tr(*args)
        return args


def _resize(img: np.ndarray, size_hw: Tuple[int, int], nearest: bool = False):
    import cv2
    interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    out = cv2.resize(img, (size_hw[1], size_hw[0]), interpolation=interp)
    if img.ndim == 3 and out.ndim == 2:
        out = out[..., None]
    return out


def _center_crop(img: np.ndarray, size_hw: Tuple[int, int]):
    h, w = img.shape[:2]
    th, tw = size_hw
    top = max((h - th) // 2, 0)
    left = max((w - tw) // 2, 0)
    return img[top:top + th, left:left + tw]


class ResizeStereo:
    """Aspect-preserving resize + center crop; nearest for masks
    (reference dataset/transforms.py:20-39)."""

    def __init__(self, size):
        # reference stores (H, W) from an (W, H) size argument
        self.size = (int(size[1]), int(size[0]))

    def __call__(self, left: np.ndarray, right: np.ndarray,
                 mask: Optional[np.ndarray] = None):
        h, w = left.shape[:2]
        scale = max(self.size[0] / h, self.size[1] / w)
        mid = (int(scale * h), int(scale * w))
        left = _center_crop(_resize(left, mid), self.size)
        right = _center_crop(_resize(right, mid), self.size)
        if mask is not None:
            m = mask.astype(np.uint8)
            mask = _center_crop(_resize(m, mid, nearest=True), self.size) > 0
        return left, right, mask
