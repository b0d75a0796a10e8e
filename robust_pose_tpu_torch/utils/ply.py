"""ASCII PLY point-cloud writer (the port's copy of
``robust_pose_tpu/utils/ply.py``)."""
from __future__ import annotations

import os

import numpy as np


def save_ply(pts: np.ndarray, rgb: np.ndarray, path: str):
    """Write an ASCII PLY with xyz + uchar rgb.

    :param pts: (N, 3) float points
    :param rgb: (N, 3) colors in [0, 255]
    """
    pts = np.asarray(pts, dtype=np.float32)
    rgb = np.asarray(rgb)
    assert pts.shape == rgb.shape
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\n")
        f.write("format ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(pts, rgb.astype(np.uint8)):
            f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")
