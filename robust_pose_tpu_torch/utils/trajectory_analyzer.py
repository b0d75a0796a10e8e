"""Trajectory plots (port of ``robust_pose_tpu/utils/trajectory_analyzer.py``):
xyz-against-time panels or one 3D plot of (N, 4, 4) pose arrays. matplotlib
is imported when an analyzer is made (the Agg backend where none is set)."""
from __future__ import annotations

import numpy as np


class TrajectoryAnalyzer:
    def __init__(self, plot_3d: bool = False, title: str = ""):
        import matplotlib

        if not matplotlib.get_backend():
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self._plt = plt
        if plot_3d:
            self.fig = plt.figure(figsize=(7, 7))
            self.ax = self.fig.add_subplot(projection="3d")
        else:
            self.fig, self.ax = plt.subplots(1, 3, figsize=(9, 2.5))
        self._3d = plot_3d
        if title:
            self.fig.suptitle(title)
        self.label = []

    def add_pose_trajectory(self, pose: np.ndarray, label: str = "",
                            color="b", linewidth=0.5, linestyle="solid"):
        """:param pose: (N, 4, 4) pose matrices"""
        self.label.append(label)
        if self._3d:
            self.ax.plot(pose[:, 0, 3], pose[:, 1, 3], pose[:, 2, 3],
                         linestyle=linestyle, color=color,
                         linewidth=linewidth, markersize=3, label=label)
            self.ax.set_xlabel("x (mm)")
            self.ax.set_ylabel("y (mm)")
            self.ax.set_zlabel("z (mm)")
        else:
            for i, axis_name in enumerate("xyz"):
                self.ax[i].plot(pose[:, i, 3], linestyle=linestyle,
                                color=color, linewidth=linewidth, label=label)
                self.ax[i].set_xlabel("t (frame)")
                self.ax[i].set_ylabel(f"{axis_name} (mm)")
                self.ax[i].grid(linestyle="dashed", linewidth=0.1)

    def write_file(self, path: str):
        self._plt.tight_layout()
        self.fig.savefig(path, bbox_inches="tight")

    def show(self):
        self.fig.canvas.draw()
        self._plt.tight_layout()
        self._plt.show()

    def legend(self):
        if self._3d:
            self._plt.legend()
        else:
            self.ax[2].legend()
