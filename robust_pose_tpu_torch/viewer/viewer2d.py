"""2D matplotlib viewer (port of ``robust_pose_tpu/viewer/viewer2d.py``).

A panel a frame of image, depth, flow and the 2D and 3D confidence
weights, saved to ``<outpath>/imgs`` and, where matplotlib can show
figures, drawn interactively. The flow is coloured with the standard
optical-flow colour wheel, in numpy. matplotlib is imported when a viewer
is made; tensors given to it are copied to the host.
"""
from __future__ import annotations

import os

import numpy as np


def _color_wheel() -> np.ndarray:
    """Standard Middlebury flow colour wheel (55 colours)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


def flow_to_image(flow: np.ndarray) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 colour coding."""
    u, v = np.asarray(flow[..., 0], float), np.asarray(flow[..., 1], float)
    rad = np.sqrt(u ** 2 + v ** 2)
    rad_max = max(rad.max(), 1e-5)
    u, v = u / rad_max, v / rad_max
    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi
    wheel = _color_wheel()
    ncols = len(wheel)
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros((*u.shape, 3), np.uint8)
    for c in range(3):
        col0 = wheel[k0, c] / 255.0
        col1 = wheel[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        col = 1 - rad * (1 - col)
        img[..., c] = np.floor(255 * col)
    return img


def to_host(x) -> np.ndarray:
    """A tensor (any device, any float type) or array as a numpy array;
    half-precision maps widen to f32."""
    if hasattr(x, "detach"):
        x = x.detach()
        if x.is_floating_point():
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Viewer2D:
    """:param outpath: the run's folder; panels go to ``<outpath>/imgs``
    :param blocking: wait for the window to be closed after each frame"""

    def __init__(self, outpath: str = None, blocking: bool = False):
        try:
            import matplotlib.pyplot as plt

            self.show = True
        except ImportError:  # headless
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            self.show = False
        self._plt = plt
        self.blocking = blocking
        self.outpath = os.path.join(outpath, "imgs") if outpath else None
        if (not blocking) and self.show:
            plt.ion()
        if self.outpath is not None:
            os.makedirs(self.outpath, exist_ok=True)

    def __call__(self, frame, weights, flow, idx: int = 0):
        """:param frame: ``img`` (1, H, W, 3) in [0, 255] and ``depth``
            (1, H, W, 1)
        :param weights: (conf1, conf2), each (1, H, W, 1)
        :param flow: (1, H, W, 2)"""
        plt = self._plt
        fig, ax = plt.subplots(1, 5, num=1, clear=True, figsize=(10, 8))
        img_t = to_host(frame.img)[0] / 255.0
        depth_t = to_host(frame.depth)[0, ..., 0]
        flow_rgb = flow_to_image(to_host(flow)[0])
        panels = [
            (np.clip(img_t, 0, 1), "I_t"),
            (depth_t, "depth_t"),
            (flow_rgb, "flow"),
            (to_host(weights[0])[0, ..., 0], "w_2d"),
            (to_host(weights[1])[0, ..., 0], "w_3d"),
        ]
        for a, (im, title) in zip(ax, panels):
            a.imshow(im, vmin=0 if im.ndim == 2 else None)
            a.axis("off")
            a.set_title(title)
        plt.tight_layout()
        if self.outpath is not None:
            plt.savefig(os.path.join(self.outpath, f"vis_{idx:06d}.png"),
                        dpi=150)
        if self.blocking and self.show:
            plt.show()
        elif self.show:
            plt.draw()
            plt.pause(0.0001)
        else:
            plt.close()
