"""Stereo mp4 video dataset (port of ``robust_pose_tpu/data/video_dataset.py``).

Iterable host-side decoder: frame subsampling, vertically stacked stereo
split (top = left), specularity masking, resize then rectify, timestamps
from a side-car JSON, poses via ``read_freiburg``. The decoder (cv2
``VideoCapture``) sits in ``_frame_count`` and ``_frames`` alone, so a
subclass can feed frames from memory; cv2 is imported only there and in
the host masking and resize of the non-``raw`` mode.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from robust_pose_tpu_torch import se3
from robust_pose_tpu_torch.data.stereo_dataset import mask_specularities
from robust_pose_tpu_torch.data.transforms import ResizeStereo
from robust_pose_tpu_torch.utils.trajectory import read_freiburg


class StereoVideoDataset:
    """Yields (limg (3,H,W) f32, rimg, mask (1,H,W) bool, pose_vec (7,),
    img_number str) per frame; with ``raw`` set, (limg (H0,W0,3) uint8,
    rimg, pose_vec, img_number) at decode scale, for ``DevicePreproc``."""

    def __init__(self, video_file: str, pose_file: Optional[str] = None,
                 img_size: Optional[Tuple] = None,
                 rectify: Optional[Callable] = None, sample: int = 1):
        self.video_file = video_file
        assert os.path.isfile(self.video_file)
        self.rectify = rectify
        # raw mode: yield the decode-scale uint8 stereo halves untouched
        # (mask/resize/rectify run on the device: data/device_preproc.py)
        self.raw = False
        ts_file = self.video_file.replace(".mp4", ".json")
        if os.path.isfile(ts_file):
            with open(ts_file, "r") as f:
                self.timestamps = [s["timestamp"] for s in json.load(f)]
        else:
            self.timestamps = None
        self.transform = ResizeStereo(img_size) if img_size is not None else None
        self.length = int(self._frame_count() / sample)
        self.sample = sample

        self.poses = None
        if pose_file is not None and os.path.isfile(pose_file):
            self.poses = read_freiburg(pose_file)

    def _frame_count(self) -> int:
        import cv2
        grabber = cv2.VideoCapture(self.video_file)
        n = grabber.get(cv2.CAP_PROP_FRAME_COUNT)
        grabber.release()
        return n

    def _frames(self) -> Iterator[np.ndarray]:
        """The decoded frames in order, RGB uint8 (2 H0, W0, 3)."""
        import cv2
        grabber = cv2.VideoCapture(self.video_file)
        while True:
            ret, img = grabber.read()
            if not ret:
                break
            yield cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        grabber.release()

    def __iter__(self):
        return self._parse_video()

    def _parse_video(self):
        for counter, img in enumerate(self._frames(), start=1):
            if (counter - 1) % self.sample != 0:
                continue
            limg, rimg = self._split_stereo_img(img)
            if self.poses is not None:
                if self.poses.shape[0] <= (counter - 1):
                    break
                pose = self.poses[counter - 1]
            else:
                pose = se3.identity(()).numpy()
            num = (self.timestamps[counter - 1]
                   if self.timestamps is not None else counter)

            if self.raw:
                yield limg, rimg, np.asarray(pose), str(num)
                continue

            mask = mask_specularities(limg)
            limg = limg.astype(np.float32)
            rimg = rimg.astype(np.float32)
            if self.transform is not None:
                limg, rimg, mask = self.transform(limg, rimg, mask)
            if self.rectify is not None:
                limg, rimg = self.rectify(limg, rimg)
            yield (limg.transpose(2, 0, 1), rimg.transpose(2, 0, 1),
                   mask[None].astype(bool), np.asarray(pose), str(num))

    def __len__(self):
        return self.length

    @staticmethod
    def _split_stereo_img(img: np.ndarray):
        h = img.shape[0]
        return img[: h // 2], img[h // 2:]  # top = left (video_dataset.py:74-78)
