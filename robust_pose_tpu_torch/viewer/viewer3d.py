"""Interactive 3D viewer (port of ``robust_pose_tpu/viewer/viewer3d.py``).
open3d is a host-side dependency, imported when a viewer or a point cloud
is made."""
from __future__ import annotations

import numpy as np
import torch

from robust_pose_tpu_torch.utils.trajectory import vec2mat


def surfels_to_open3d(state, depth_scale: float = 1.0, stable: bool = True):
    """The active surfels of a ``SurfelState`` (``stable``: those with
    conf >= 1) as an ``open3d.geometry.PointCloud``, points divided by
    ``depth_scale``, colours in [0, 1]. The selection is made where the
    state lies and copied to the host once."""
    import open3d

    sel = state.active
    if stable:
        sel = sel & (state.conf >= 1.0)
    pts = torch.cat([state.opts[sel] / depth_scale, state.rgb[sel] / 255.0],
                    dim=-1).double().cpu().numpy()
    pcd = open3d.geometry.PointCloud()
    pcd.points = open3d.utility.Vector3dVector(pts[:, :3])
    pcd.colors = open3d.utility.Vector3dVector(pts[:, 3:])
    return pcd


class Viewer3D:
    """The camera follows the pose; q continues, d toggles the canonical
    and the deformed model."""

    def __init__(self, image_shape, blocking: bool = False):
        import open3d as o3d

        self.blocking = blocking
        self.exit_loop = not blocking
        self.image_height, self.image_width = image_shape
        self.viewer = o3d.visualization.VisualizerWithKeyCallback()
        self.viewer.register_key_callback(81, self._exit_cb)   # q
        self.viewer.register_key_callback(68, self._deform_cb)  # d
        self.viewer.create_window(width=self.image_width,
                                  height=self.image_height, visible=True)
        self.control = self.viewer.get_view_control()
        self.ref_view = self.control.convert_to_pinhole_camera_parameters()
        self.viewer.get_render_option().background_color = np.full(3, 55 / 255.0)
        self.pcd = None
        self.def_pcd = None
        self.is_deformed = False

    def _pose2view(self, pose_vec):
        self.ref_view.extrinsic = np.linalg.inv(vec2mat(np.asarray(pose_vec))[0])
        return self.ref_view

    def _exit_cb(self, _):
        self.exit_loop = True

    def _deform_cb(self, _):
        self.pose = self.control.convert_to_pinhole_camera_parameters()
        self.is_deformed = not self.is_deformed
        print("deformed/current" if self.is_deformed else "canonical/current")
        self.viewer.remove_geometry(self.pcd)
        self.pcd, self.def_pcd = self.def_pcd, self.pcd
        self.viewer.add_geometry(self.pcd)
        self.control.convert_from_pinhole_camera_parameters(self.pose)

    def __call__(self, pose_vec, pcd=None, add_pcd=None, def_pcd=None):
        self.pose = self._pose2view(pose_vec)
        self.is_deformed = False
        self.def_pcd = def_pcd
        self.exit_loop = not self.blocking
        if self.blocking:
            print("blocking mode: press q to continue, d to toggle model")
        if add_pcd is not None:
            self.viewer.add_geometry(add_pcd)
        if pcd is not None:
            self.viewer.remove_geometry(self.pcd, reset_bounding_box=True)
            self.pcd = pcd
            self.viewer.add_geometry(self.pcd)
        self.control.convert_from_pinhole_camera_parameters(self.pose)
        self.viewer.poll_events()
        self.viewer.update_renderer()
        while not self.exit_loop:
            self.viewer.poll_events()
            self.viewer.update_renderer()
        if add_pcd is not None:
            self.viewer.remove_geometry(add_pcd)
