"""Trajectory comparison plots of one sequence (port of
``evaluation/trajectory_plots.py``): xyz against time for each method and
the ground truth, each trajectory from its first pose or, with
``--prealign``, aligned to the ground truth (Horn)::

    python -m robust_pose_tpu_torch.evaluation.trajectory_plots \\
        <dataset>/<keyframe> [--methods orbslam2 ours ground-truth] \\
        [--prealign] [--out figure.pdf]

A method's trajectory is ``<dataset>/<keyframe>/data/<method>/
trajectory.freiburg``; the ground truth is ``groundtruth.txt`` beside
``data``. Each method's ATE and RPE are printed.
"""
import argparse
import os

import numpy as np

COLORS = {
    "ground-truth": ["k", 2.5, "dashed"],
    "orbslam2": ["b", 1, "dashdot"],
    "efusion": ["m", 0.5, "solid"],
    "ours": ["goldenrod", 2.5, "solid"],
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Plot Trajectories")
    parser.add_argument("base_path", type=str, help="Path to dataset keyframe.")
    parser.add_argument("--methods", type=str, nargs="+",
                        default=["orbslam2", "ours", "ground-truth"])
    parser.add_argument("--prealign", action="store_true")
    parser.add_argument("--out", type=str, default=None)
    return parser


def main(argv=None):
    from robust_pose_tpu_torch.utils.evaluate import evaluate
    from robust_pose_tpu_torch.utils.trajectory import read_freiburg, vec2mat
    from robust_pose_tpu_torch.utils.trajectory_analyzer import TrajectoryAnalyzer

    args = build_parser().parse_args(argv)
    keyframe = os.path.basename(args.base_path)
    dataset = os.path.basename(os.path.dirname(args.base_path))
    plotter = TrajectoryAnalyzer(title=f"{dataset}/{keyframe}")

    paths = {m: os.path.join(args.base_path, "data", m, "trajectory.freiburg")
             for m in args.methods if m != "ground-truth"}
    gt_path = os.path.join(args.base_path, "groundtruth.txt")

    for meth, path in paths.items():
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{meth} does not exist: {path}")
        ate, rpe_t, rpe_r, *_, T, gt_poses, _ = evaluate(
            gt_path, path, offset=-4, ret_align_T=True)
        print(meth)
        print("ATE-RMSE:", ate, " mm")
        print("RPE-trans:", rpe_t, " mm")
        print("RPE-rot:", rpe_r)
        pose_arrs = vec2mat(read_freiburg(path))
        if args.prealign:
            pose_arrs = T[None] @ pose_arrs
        else:
            pose_arrs = np.linalg.inv(pose_arrs[0])[None] @ pose_arrs
        c = COLORS.get(meth, ["g", 1, "solid"])
        plotter.add_pose_trajectory(
            pose_arrs, label="ORB-SLAM2" if meth == "orbslam2" else meth,
            color=c[0], linewidth=c[1], linestyle=c[2])

    if "ground-truth" in args.methods and os.path.isfile(gt_path):
        poses = vec2mat(read_freiburg(gt_path))
        if not args.prealign:
            poses = np.linalg.inv(poses[0])[None] @ poses
        c = COLORS["ground-truth"]
        plotter.add_pose_trajectory(poses, label="ground-truth", color=c[0],
                                    linewidth=c[1], linestyle=c[2])
    plotter.legend()
    out = args.out or (os.path.basename(args.base_path) + ".pdf")
    plotter.write_file(out)
    print(f"saved {out}")
    return out


if __name__ == "__main__":
    main()
