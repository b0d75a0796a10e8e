"""Offscreen trajectory video (port of
``robust_pose_tpu/viewer/view_renderer.py``): each frame's open3d capture
from the camera's pose, written to ``<outpath>/vis.mp4``. open3d and cv2
are imported when a renderer is made."""
from __future__ import annotations

import os

import numpy as np

from robust_pose_tpu_torch.utils.trajectory import vec2mat


class ViewRenderer:
    def __init__(self, image_shape, outpath: str):
        import cv2
        import open3d as o3d

        self._cv2 = cv2
        self.image_height, self.image_width = image_shape
        self.viewer = o3d.visualization.VisualizerWithKeyCallback()
        self.viewer.create_window(width=self.image_width,
                                  height=self.image_height, visible=True)
        self.vid_writer = cv2.VideoWriter(
            os.path.join(outpath, "vis.mp4"),
            cv2.VideoWriter_fourcc(*"MP4V"), 25.0,
            (image_shape[1], image_shape[0] - 1),
        )
        self.control = self.viewer.get_view_control()
        self.ref_view = self.control.convert_to_pinhole_camera_parameters()
        self.viewer.get_render_option().background_color = np.full(3, 55 / 255.0)
        self.pcd = None

    def __del__(self):
        if hasattr(self, "vid_writer"):
            self.vid_writer.release()

    def _pose2view(self, pose_vec):
        self.ref_view.extrinsic = np.linalg.inv(vec2mat(np.asarray(pose_vec))[0])
        return self.ref_view

    def __call__(self, pose_vec, pcd):
        self.viewer.remove_geometry(self.pcd, reset_bounding_box=True)
        self.pcd = pcd
        self.viewer.add_geometry(self.pcd)
        self.control.convert_from_pinhole_camera_parameters(
            self._pose2view(pose_vec))
        self.control.set_zoom(0.5)
        self.viewer.poll_events()
        self.viewer.update_renderer()
        image = self.viewer.capture_screen_float_buffer(False)
        self.vid_writer.write(
            self._cv2.cvtColor((255 * np.asarray(image)).astype(np.uint8),
                               self._cv2.COLOR_RGB2BGR))
        return image
