"""Flow and warp debug plots (port of ``robust_pose_tpu/utils/plotting.py``).

The warps run on the port's geometry and warp ops, on the device of the
depth or flow given (numpy arrays go to the CPU); the results come back as
uint8 host images, and the figure is drawn on the host with matplotlib,
imported by ``plot_res``.
"""
from __future__ import annotations

import numpy as np
import torch

from robust_pose_tpu_torch.ops.geometry import create_img_coords, project, reproject
from robust_pose_tpu_torch.ops.warp import grid_sample, remap_from_flow_nearest
from robust_pose_tpu_torch.viewer.viewer2d import flow_to_image, to_host


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.float32)


def _get_warpfield(depth, pose, intrinsics, img_coords):
    """Pixel coordinates (B, N, 2) that the pose sends each pixel to."""
    opts = reproject(depth, intrinsics, img_coords)
    return project(opts[..., :3], intrinsics, pose)[..., :2]


def warp_frame(src_frame, depth, pose, intrinsics) -> np.ndarray:
    """Warp an image by the flow the pose induces (nearest samples).

    :param src_frame: (H, W, 3) image
    :param depth: (H, W, 1) depth
    :param pose: (7,) SE(3) vector
    :param intrinsics: (3, 3)
    :return: (H, W, 3) uint8
    """
    depth = _f32(depth)
    dev = depth.device
    h, w = depth.shape[0], depth.shape[1]
    coords = create_img_coords(h, w, device=dev)
    wf = _get_warpfield(depth[None], _f32(pose, dev)[None],
                        _f32(intrinsics, dev)[None], coords)
    out = grid_sample(_f32(src_frame, dev)[None], wf[..., 0] - 0.5,
                      wf[..., 1] - 0.5, mode="nearest")
    return to_host(out).reshape(h, w, 3).astype(np.uint8)


def warp_frame_flow(src_frame, flow) -> np.ndarray:
    """Warp an image by an optical flow field (nearest samples); (H, W, 3)
    uint8."""
    flow = _f32(flow)
    out, _ = remap_from_flow_nearest(_f32(src_frame, flow.device)[None],
                                     flow[None])
    return to_host(out[0]).astype(np.uint8)


def plot_res(img1_batch, img2_batch, flow_batch, depth2_batch, pose_batch,
             conf1_batch, conf2_batch, intrinsics, n: int = 2):
    """Debug grid of the first ``n`` samples: img1 | img2 | flow warp |
    pose warp | flow | conf1 | conf2 (NHWC batches). Returns (fig, axs)."""
    import matplotlib.pyplot as plt

    rows = []
    for i in range(min(n, len(img1_batch))):
        img1 = to_host(img1_batch[i]).astype(np.uint8)
        img2 = to_host(img2_batch[i]).astype(np.uint8)
        w_flow = warp_frame_flow(img1, flow_batch[i])
        w_pose = warp_frame(img1, depth2_batch[i], pose_batch[i], intrinsics[i])
        flow_img = flow_to_image(to_host(flow_batch[i]))
        c1 = (255 * to_host(conf1_batch[i])).astype(np.uint8)
        c2 = (255 * to_host(conf2_batch[i])).astype(np.uint8)
        rows.append([img1, img2, w_flow, w_pose, flow_img,
                     np.repeat(c1, 3, -1), np.repeat(c2, 3, -1)])

    fig, axs = plt.subplots(nrows=len(rows), ncols=len(rows[0]), squeeze=False)
    for r, row in enumerate(rows):
        for c, img in enumerate(row):
            axs[r, c].imshow(img)
            axs[r, c].set(xticklabels=[], yticklabels=[], xticks=[], yticks=[])
    plt.tight_layout()
    return fig, axs
