"""Preprocessed-PNG stereo dataset (port of
``robust_pose_tpu/data/stereo_dataset.py``; host numpy/cv2, cv2 imported
where images are read, masked or resized).
"""
from __future__ import annotations

import glob
import os
from typing import Optional, Tuple

import numpy as np

from robust_pose_tpu_torch.data.transforms import ResizeStereo


def mask_specularities(img: np.ndarray, mask: Optional[np.ndarray] = None,
                       spec_thr: float = 0.96) -> np.ndarray:
    """Specular-highlight mask: sum(rgb) < 3*255*thr, then 11x11 erosion
    (reference stereo_dataset.py:12-16)."""
    import cv2
    spec_mask = img.sum(axis=-1) < (3 * 255 * spec_thr)
    mask = mask & spec_mask if mask is not None else spec_mask
    return cv2.erode(mask.astype(np.uint8), kernel=np.ones((11, 11))) > 0


class StereoDataset:
    """Map-style dataset over ``video_frames*/*l.png`` with side-car masks.

    __getitem__ -> (limg (3,H,W) f32 [0,255], rimg, mask (1,H,W) bool,
    img_number str) — mirrors the reference contract.
    """

    def __init__(self, input_folder: str, img_size: Tuple):
        self.imgs = sorted(
            glob.glob(os.path.join(input_folder, "video_frames*", "*l.png"))
        )
        assert len(self.imgs) > 0, f"no frames in {input_folder}"
        self.transform = ResizeStereo(img_size)

    def __getitem__(self, item: int):
        import cv2
        limg = cv2.cvtColor(cv2.imread(self.imgs[item]), cv2.COLOR_BGR2RGB)
        rimg = cv2.cvtColor(
            cv2.imread(self.imgs[item].replace("l.png", "r.png")),
            cv2.COLOR_BGR2RGB,
        )
        img_number = os.path.basename(self.imgs[item]).split("l.png")[0]
        mask_path = self.imgs[item].replace("video_frames", "masks")
        mask_img = cv2.imread(mask_path, cv2.IMREAD_GRAYSCALE)
        if mask_img is None:
            mask = np.ones(limg.shape[:2], dtype=bool)
        else:
            mask = cv2.resize(
                mask_img, dsize=(limg.shape[1], limg.shape[0]),
                interpolation=cv2.INTER_NEAREST,
            ) > 0
        mask = mask_specularities(limg, mask)

        limg, rimg, mask = self.transform(
            limg.astype(np.float32), rimg.astype(np.float32), mask
        )
        limg = limg.transpose(2, 0, 1)
        rimg = rimg.transpose(2, 0, 1)
        return limg, rimg, mask[None].astype(bool), img_number

    def __len__(self):
        return len(self.imgs)
