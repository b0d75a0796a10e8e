"""Training pair datasets (port of ``robust_pose_tpu/data/train_datasets.py``).

``PoseDataset`` samples frame pairs of one sequence folder with a random
temporal step and computes their ground-truth relative poses from the
freiburg file; ``get_data`` concatenates the sequences of a config, each
with its rectified calibration (host-side, ``cv2.stereoRectify``). Host
numpy throughout, with the JAX package's generator calls, so the same
folder gives the same pairs. cv2 is imported inside the functions that
decode: a dataset from memory overrides ``_read_img`` / ``_read_mask``.
"""
from __future__ import annotations

import os
from glob import glob
from typing import List, Sequence, Tuple

import numpy as np

from robust_pose_tpu_torch.data.dataset_utils import find_calib_file
from robust_pose_tpu_torch.data.rectification import StereoRectifier
from robust_pose_tpu_torch.utils.trajectory import mat2vec, read_freiburg, vec2mat


class ConcatDataset:
    """The concatenation of map-style datasets (empty ones dropped)."""

    def __init__(self, datasets: Sequence):
        self.datasets = [d for d in datasets if len(d) > 0]
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx: int):
        ds = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[ds][idx - self._offsets[ds]]


def _rel_pose(p1_vec: np.ndarray, p2_vec: np.ndarray) -> np.ndarray:
    """poses[i]^-1 * poses[i+s] as a 7-vector."""
    m = np.linalg.inv(vec2mat(p1_vec)[0]) @ vec2mat(p2_vec)[0]
    return mat2vec(m[None])[0]


class PoseDataset:
    """Frame pairs of one sequence folder (``video_frames/NNNNNNl.png`` /
    ``r.png``, optional ``masks/NNNNNNl.png``, ``groundtruth.txt``).

    ``__getitem__`` -> (img1, img2, img1r, img2r (3, H, W) f32 RGB, mask1,
    mask2 (1, H, W) bool, pose_vec (7,) f32, intrinsics (3, 3) f32,
    baseline f32), the pose translation and the baseline divided by
    ``depth_cutoff`` (normalized depth).
    """

    def __init__(self, root: str, baseline: float, intrinsics: np.ndarray,
                 depth_cutoff: float = 300.0, conf_thr: float = 0.0,
                 step=(1, 10), img_size=(512, 640), samples: int = -1,
                 rng: np.random.Generator = None):
        rng = rng or np.random.default_rng(1234)
        images_l = sorted(glob(os.path.join(root, "video_frames", "*l.png")))
        images_r = sorted(glob(os.path.join(root, "video_frames", "*r.png")))
        masks = sorted(glob(os.path.join(root, "masks", "*l.png")))
        if not images_l or len(images_l) != len(images_r):
            raise FileNotFoundError(f"{root}: {len(images_l)} left and "
                                    f"{len(images_r)} right frames")
        poses = read_freiburg(os.path.join(root, "groundtruth.txt"))
        n_list = images_l if len(masks) == 0 else masks
        if isinstance(step, int):
            step = (step, step)
        sample_list = self._random_sample(step, samples, len(n_list), rng)

        self.depth_cutoff = depth_cutoff
        self.image_list: List = []
        self.image_list_r: List = []
        self.mask_list: List = []
        self.rel_pose_list: List = []
        for i in sample_list:
            s = int(rng.integers(*step)) if step[0] < step[1] else step[0]
            n1 = int(os.path.basename(n_list[i]).split("l.png")[0])
            n2 = int(os.path.basename(n_list[i + s]).split("l.png")[0])
            self.image_list.append([
                n_list[i].replace("masks", "video_frames"),
                n_list[i + s].replace("masks", "video_frames"),
            ])
            self.rel_pose_list.append(_rel_pose(poses[n1 - 1], poses[n2 - 1]))
            self.image_list_r.append([
                p.replace("l.png", "r.png") for p in self.image_list[-1]
            ])
            if len(masks) == 0:
                self.mask_list.append([None, None])
            else:
                self.mask_list.append([
                    n_list[i].replace("video_frames", "masks"),
                    n_list[i + s].replace("video_frames", "masks"),
                ])
        self.img_size = tuple(img_size)
        self.intrinsics = np.asarray(intrinsics, np.float32)
        self.baseline = float(baseline)

    def __getitem__(self, index: int):
        img1 = self._read_img(self.image_list[index][0])
        img2 = self._read_img(self.image_list[index][1])
        img1r = self._read_img(self.image_list_r[index][0])
        img2r = self._read_img(self.image_list_r[index][1])
        pose = self.rel_pose_list[index].copy()
        pose[:3] /= self.depth_cutoff
        baseline = self.baseline / self.depth_cutoff
        mask1 = self._read_mask(self.mask_list[index][0])
        mask2 = self._read_mask(self.mask_list[index][1])
        return (img1, img2, img1r, img2r, mask1, mask2,
                pose.astype(np.float32), self.intrinsics, np.float32(baseline))

    def _read_img(self, path: str) -> np.ndarray:
        """The image at ``path``, resized to ``img_size``: (3, H, W) f32 RGB."""
        import cv2

        img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        img = cv2.resize(img, (self.img_size[1], self.img_size[0]),
                         interpolation=cv2.INTER_LINEAR)
        return img.transpose(2, 0, 1).astype(np.float32)

    def _read_mask(self, path) -> np.ndarray:
        """The mask at ``path`` (all True for None): (1, H, W) bool."""
        if path is None:
            return np.ones((1, *self.img_size), dtype=bool)
        import cv2

        mask = cv2.imread(path, cv2.IMREAD_GRAYSCALE) > 0
        mask = cv2.resize(mask.astype(np.uint8),
                          (self.img_size[1], self.img_size[0]),
                          interpolation=cv2.INTER_NEAREST) > 0
        return mask[None]

    def __len__(self):
        return len(self.image_list)

    @staticmethod
    def _random_sample(step, samples, total, rng):
        if (samples > 0) and (samples < total):
            return sorted(rng.choice(total - step[1], size=samples,
                                     replace=False))
        return np.arange(total - step[1])


def get_data(config: dict, img_size: Tuple, depth_cutoff: float) -> ConcatDataset:
    """The sequences of ``config`` (``basepath``, ``sequences``, ``step``,
    ``samples``) as one dataset: each sequence's ``keyframe_*`` folders, or
    the sequence folder itself, with the calibration of its rectification
    (conventional mode) at ``img_size`` (H, W). Folders without a
    ``groundtruth.txt`` or without images are skipped."""
    rng = np.random.default_rng(1234)
    img_size = tuple(img_size)
    baseline, intrinsics = [], []
    for seq in config["sequences"]:
        calib_path = os.path.join(config["basepath"], seq, "keyframe_1")
        if not os.path.exists(calib_path):
            calib_path = os.path.join(config["basepath"], seq)
        rect = StereoRectifier(find_calib_file(calib_path),
                               img_size_new=(img_size[1], img_size[0]),
                               mode="conventional")
        calib = rect.get_rectified_calib()
        baseline.append(np.float32(calib["bf"]))
        intrinsics.append(calib["intrinsics"]["left"].astype(np.float32))

    ds = [sorted(glob(os.path.join(config["basepath"], s, "keyframe_*")))
          for s in config["sequences"]]
    if len(ds[0]) == 0:
        ds = [[os.path.join(config["basepath"], s)]
              for s in config["sequences"]]

    subsets = []
    for i, _ in enumerate(config["sequences"]):
        for d in ds[i]:
            if os.path.isfile(os.path.join(d, "groundtruth.txt")):
                try:
                    subsets.append(PoseDataset(
                        d, baseline[i], intrinsics[i], depth_cutoff, 0.0,
                        config["step"], img_size, config["samples"], rng=rng,
                    ))
                except FileNotFoundError:    # no frames, or unpaired ones
                    pass
    return ConcatDataset(subsets)
