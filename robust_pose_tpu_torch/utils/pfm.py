"""PFM image IO (port of ``robust_pose_tpu/utils/pfm.py``; the files it
writes are byte-equal to the JAX package's)."""
from __future__ import annotations

import re
import sys
from typing import Tuple

import numpy as np


def load_pfm(file_path: str) -> Tuple[np.ndarray, float]:
    """Load a PFM file -> (H x W [x 3] array, scale)."""
    with open(file_path, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError(f"{file_path}: not a PFM file")
        dim_match = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode("utf-8"))
        if not dim_match:
            raise ValueError(f"{file_path}: malformed PFM header")
        width, height = map(int, dim_match.groups())
        scale = float(f.readline().decode("utf-8").rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(np.reshape(data, shape)), abs(scale)


def save_pfm(img_arr: np.ndarray, file_path: str, scale: float = 1,
             norm: bool = False) -> bool:
    """Save an H x W, H x W x 1 or H x W x 3 array as PFM in the host's
    byte order; a ``scale`` other than 1 (or ``norm``) min-max normalizes
    the values first."""
    norm = True if scale != 1 else norm
    img_arr = img_arr.astype(np.float32)
    if norm:
        img_arr = (img_arr - np.min(img_arr)) / (np.max(img_arr) - np.min(img_arr))
    img_arr = np.flipud(img_arr)
    if img_arr.ndim == 3 and img_arr.shape[2] == 3:
        color = True
    elif img_arr.ndim == 2 or (img_arr.ndim == 3 and img_arr.shape[2] == 1):
        color = False
    else:
        raise ValueError("image must have H x W x 3, H x W x 1 or H x W dims")
    with open(file_path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{img_arr.shape[1]} {img_arr.shape[0]}\n".encode())
        endian = img_arr.dtype.byteorder
        if endian == "<" or (endian == "=" and sys.byteorder == "little"):
            scale = -scale
        f.write(f"{scale:f}\n".encode())
        img_arr.tofile(f)
    return True
