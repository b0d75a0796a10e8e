"""Dataset dispatch, sequential subsampler and the host loaders (port of
``robust_pose_tpu/data/dataset_utils.py``).
"""
from __future__ import annotations

import glob
import os
from typing import Iterator, Tuple

from robust_pose_tpu_torch.data.rectification import StereoRectifier
from robust_pose_tpu_torch.data.stereo_dataset import StereoDataset
from robust_pose_tpu_torch.data.video_dataset import StereoVideoDataset

CALIB_CANDIDATES = (
    "camcal.json",
    "camera_calibration.json",
    "StereoCalibration.ini",
    "endoscope_calibration.yaml",
)


def find_calib_file(input_path: str) -> str:
    for name in CALIB_CANDIDATES:
        p = os.path.join(input_path, name)
        if os.path.isfile(p):
            return p
    raise RuntimeError(f"no valid calibration file found in {input_path}")


def get_data(input_path: str, img_size: Tuple, sample_video: int = 1,
             rect_mode: str = "conventional"):
    """Discover calibration, build the rectifier, and pick preprocessed-PNG
    vs raw-video dataset (reference dataset_utils.py:10-35)."""
    img_size = tuple(img_size)
    calib_file = find_calib_file(input_path)
    rect = StereoRectifier(calib_file, img_size_new=img_size, mode=rect_mode)
    calib = rect.get_rectified_calib()
    try:
        dataset = StereoDataset(input_path, img_size=calib["img_size"])
    except AssertionError:
        video_file = glob.glob(os.path.join(input_path, "*.mp4"))[0]
        pose_file = os.path.join(input_path, "groundtruth.txt")
        dataset = StereoVideoDataset(
            video_file, pose_file, img_size=calib["img_size"],
            sample=sample_video, rectify=rect,
        )
    return dataset, calib


class SequentialSubSampler:
    """Sequential index sampler with start/stop/step
    (reference dataset_utils.py:38-58)."""

    def __init__(self, data_source, start: int = 0, stop: int = -1,
                 step: int = 1):
        self.data_source = data_source
        self.start = start
        self.stop = stop
        self.step = step

    def __iter__(self) -> Iterator[int]:
        stop = min(self.stop, len(self.data_source)) if self.stop > 0 \
            else len(self.data_source)
        return iter(range(self.start, stop, self.step))

    def __len__(self):
        return int(len(self.data_source) / self.step)


def iterate_dataset(dataset, sampler: SequentialSubSampler = None):
    """Minimal loader: map-style datasets honor the sampler; iterable
    datasets stream (reference wraps these in a torch DataLoader with
    num_workers=1 — scripts/infer_trajectory.py:53-57)."""
    if hasattr(dataset, "__getitem__"):
        indices = sampler if sampler is not None else range(len(dataset))
        for i in indices:
            yield dataset[i]
    else:
        for item in dataset:
            yield item


def prefetch_iterator(iterable, depth: int = 2):
    """Background-thread prefetch: decode/rectify the next ``depth`` items
    while the device computes the current step (the host/device pipelining
    the reference gets from its DataLoader worker process —
    scripts/infer_trajectory.py:53-57; cv2 releases the GIL during decode).
    """
    import queue
    import threading

    q = queue.Queue(maxsize=depth)
    sentinel = object()
    err = []

    def worker():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # surface decode errors on the consumer
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item
