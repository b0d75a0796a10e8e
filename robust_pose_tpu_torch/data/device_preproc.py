"""On-device frame preprocessing (port of ``robust_pose_tpu/data/device_preproc.py``):
specularity masking, resize and the stereo-rectification remap in PyTorch
on the card, over the port's ``ops/warp.grid_sample``.

The host pipeline (``data/video_dataset.py``) runs per frame, with cv2 on
the CPU: the specularity mask at decode scale, the aspect-preserving
resize and centre crop, then the rectification remap. Here the decode
thread uploads the raw uint8 stereo halves and the rest runs on the
device, in the same order. Each op matches its cv2 counterpart:

  - ``remap_bilinear``  = cv2.remap(INTER_LINEAR, BORDER_CONSTANT=0)
  - ``remap_nearest``   = cv2.remap(INTER_NEAREST), the rectification's
    interpolation (``data/rectification.rectify_pair`` defaults to it)
  - ``erode_mask``      = cv2.erode(ones(k, k)); the border never erodes
    (cv2's default morphology border is +inf for erosion)
  - ``resize_bilinear`` = cv2.resize(INTER_LINEAR) on float input
    (half-pixel centres, replicated border)
  - ``resize_nearest``  = cv2.resize(INTER_NEAREST): output j reads input
    floor(j * w_in / w_out), no half-pixel offset
  - pseudo rectification = cv2.warpAffine translation of the right image
    by the principal-point delta (``data/rectification.pseudo_rectify_2d``)

No kernel of its own: these are gathers and elementwise passes of plain
PyTorch. Sample coordinates of the resizes are computed in float64 on the
host, as the JAX module does, and uploaded once a shape.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from robust_pose_tpu_torch.device import resolve_device
from robust_pose_tpu_torch.ops.warp import grid_sample

Tensor = torch.Tensor


def remap_bilinear(img: Tensor, map_x: Tensor, map_y: Tensor) -> Tensor:
    """cv2.remap(INTER_LINEAR, BORDER_CONSTANT=0): sample ``img`` (H, W, C)
    at float pixel coordinates (out-of-bounds reads are 0)."""
    oh, ow = map_x.shape
    out = grid_sample(img[None], map_x.reshape(1, -1), map_y.reshape(1, -1))
    return out.reshape(oh, ow, img.shape[-1])


def remap_nearest(img: Tensor, map_x: Tensor, map_y: Tensor) -> Tensor:
    """cv2.remap(INTER_NEAREST, BORDER_CONSTANT=0): each map coordinate
    rounds to ``floor(x + 0.5)``, as cv2's fixed-point rounding does over
    the non-negative map range."""
    oh, ow = map_x.shape
    out = grid_sample(img[None], map_x.reshape(1, -1), map_y.reshape(1, -1),
                      mode="nearest")
    return out.reshape(oh, ow, img.shape[-1])


def translate_bilinear(img: Tensor, tx: float, ty: float) -> Tensor:
    """cv2.warpAffine pure translation (INTER_LINEAR, BORDER_CONSTANT=0):
    dst(x, y) = src(x - tx, y - ty)."""
    h, w = img.shape[:2]
    out = grid_sample(img[None], *_translate_coords(h, w, tx, ty, img.device))
    return out.reshape(h, w, img.shape[-1])


def erode_mask(mask: Tensor, k: int = 11) -> Tensor:
    """cv2.erode with an all-ones (k, k) kernel on a boolean (H, W) mask:
    a pixel stays True when every pixel of its window inside the image is
    True. As a max over the negated mask, separable, whose padding
    (-inf) never wins: the image border does not erode."""
    p = k // 2
    x = (~mask).to(torch.float32)[None, None]
    x = F.max_pool2d(x, (k, 1), stride=1, padding=(p, 0))
    x = F.max_pool2d(x, (1, k), stride=1, padding=(0, p))
    return x[0, 0] == 0


def mask_specularities(img: Tensor, mask: Optional[Tensor] = None,
                       spec_thr: float = 0.96) -> Tensor:
    """Device twin of ``data/stereo_dataset.mask_specularities``:
    sum(rgb) < 3 * 255 * thr, optionally AND ``mask``, then the 11 x 11
    erosion."""
    spec = torch.sum(img.to(torch.float32), dim=-1) < (3 * 255 * spec_thr)
    if mask is not None:
        spec = spec & mask
    return erode_mask(spec)


def _upload(a: np.ndarray, device) -> Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).reshape(
        1, -1).to(device)


@functools.lru_cache(maxsize=16)
def _translate_coords(h: int, w: int, tx: float, ty: float, device):
    xs = np.arange(w, dtype=np.float32) - np.float32(tx)
    ys = np.arange(h, dtype=np.float32) - np.float32(ty)
    cx, cy = np.meshgrid(xs, ys)
    return _upload(cx, device), _upload(cy, device)


def _bilinear_coords(n_out: int, n_in: int) -> np.ndarray:
    # cv2.resize INTER_LINEAR: half-pixel centres, computed in float64
    return (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5


@functools.lru_cache(maxsize=16)
def _resize_coords(th: int, tw: int, h: int, w: int, device):
    xs = np.clip(_bilinear_coords(tw, w), 0.0, w - 1.0)
    ys = np.clip(_bilinear_coords(th, h), 0.0, h - 1.0)
    cx, cy = np.meshgrid(xs, ys)  # (th, tw)
    return _upload(cx, device), _upload(cy, device)


def resize_bilinear(img: Tensor, size_hw: Tuple[int, int]) -> Tensor:
    """cv2.resize(INTER_LINEAR) on float (H, W, C) input: half-pixel-centre
    bilinear with the edge taps clamped (replicated border)."""
    h, w = img.shape[:2]
    th, tw = size_hw
    if (th, tw) == (h, w):
        return img
    out = grid_sample(img[None], *_resize_coords(th, tw, h, w, img.device))
    return out.reshape(th, tw, img.shape[-1])


def resize_nearest(img: Tensor, size_hw: Tuple[int, int]) -> Tensor:
    """cv2.resize(INTER_NEAREST) of (H, W, C): output j reads input
    floor(j * w_in / w_out)."""
    h, w = img.shape[:2]
    th, tw = size_hw
    if (th, tw) == (h, w):
        return img
    ix = np.minimum(np.floor(np.arange(tw) * (w / tw)).astype(np.int64), w - 1)
    iy = np.minimum(np.floor(np.arange(th) * (h / th)).astype(np.int64), h - 1)
    return img[torch.from_numpy(iy).to(img.device)][
        :, torch.from_numpy(ix).to(img.device)]


def _center_crop(img: Tensor, size_hw: Tuple[int, int]) -> Tensor:
    h, w = img.shape[:2]
    th, tw = size_hw
    top = max((h - th) // 2, 0)
    left = max((w - tw) // 2, 0)
    return img[top:top + th, left:left + tw]


class DevicePreproc:
    """Per-frame preprocessing of the streaming inference loop on the
    device.

    ``__call__(limg_u8, rimg_u8, mask=None)`` takes the raw decode-scale
    stereo halves (H0, W0, 3) uint8 (numpy or tensors) and returns the
    model's ``(limg (3, H, W) f32, rimg (3, H, W) f32, mask (1, H, W)
    bool)`` on ``device``, in the host order: the mask at decode scale,
    then the images resized bilinear and the mask nearest, both centre
    cropped, then the images rectified (the mask is not remapped, as in
    the host pipeline).

    :param size_wh: target (W, H), as ``ResizeStereo`` takes it
    :param rectifier: an object with ``mode`` and, for 'pseudo', ``cal``
        (its ``lkmat`` / ``rkmat``: a bilinear translation of the right
        image by the principal-point delta) or, otherwise, ``maps``
        (``lmap1``, ``lmap2``, ``rmap1``, ``rmap2``: a nearest remap), such
        as a ``StereoRectifier``; None skips rectification
    :param device: ``cuda`` unless given; the maps are put there once
    """

    def __init__(self, size_wh: Tuple[int, int], rectifier=None, device=None):
        self.device = resolve_device(device)
        self.size_hw = (int(size_wh[1]), int(size_wh[0]))
        self.maps = None
        self.pseudo_shift = None
        if rectifier is not None:
            if rectifier.mode == "pseudo":
                cal = rectifier.cal
                self.pseudo_shift = (
                    float(cal["lkmat"][0][-1] - cal["rkmat"][0][-1]),
                    float(cal["lkmat"][1][-1] - cal["rkmat"][1][-1]),
                )
            else:
                self.maps = {
                    k: torch.from_numpy(np.asarray(rectifier.maps[k], np.float32)
                                        ).to(self.device)
                    for k in ("lmap1", "lmap2", "rmap1", "rmap2")}

    def _pipeline(self, limg: Tensor, rimg: Tensor, mask: Optional[Tensor]):
        th, tw = self.size_hw
        h, w = limg.shape[:2]
        scale = max(th / h, tw / w)
        mid = (int(scale * h), int(scale * w))

        m = mask_specularities(limg, mask)
        lf = _center_crop(resize_bilinear(limg.to(torch.float32), mid),
                          self.size_hw)
        rf = _center_crop(resize_bilinear(rimg.to(torch.float32), mid),
                          self.size_hw)
        m = _center_crop(resize_nearest(m[..., None], mid)[..., 0], self.size_hw)
        if self.maps is not None:
            lf = remap_nearest(lf, self.maps["lmap1"], self.maps["lmap2"])
            rf = remap_nearest(rf, self.maps["rmap1"], self.maps["rmap2"])
        elif self.pseudo_shift is not None:
            rf = translate_bilinear(rf, *self.pseudo_shift)
        return lf.permute(2, 0, 1), rf.permute(2, 0, 1), m[None]

    @torch.inference_mode()
    def __call__(self, limg_u8, rimg_u8, mask=None):
        up = lambda x: torch.as_tensor(x).to(self.device)
        return self._pipeline(up(limg_u8), up(rimg_u8),
                              None if mask is None else up(mask).bool())
