"""Trajectory inference CLI (port of ``scripts/infer_trajectory.py``).

Runs the stereo SLAM loop over a sequence folder (preprocessed PNGs or a
raw mp4 with ``--device-preproc``), writes the TUM/freiburg trajectory and
the surfel-map PLYs, and evaluates ATE/RPE when the folder holds a
``groundtruth.txt``; ``--viewer`` shows each frame (``2d``: matplotlib
panels written to ``<outpath>/imgs``; ``3d`` and ``video``: open3d, which
warn and switch off where open3d is missing)::

    python -m robust_pose_tpu_torch.scripts.infer_trajectory <sequence> \\
        --checkpoint <dir or .pth> --config configuration/infer_f2f.yaml \\
        --window 8 --device-preproc

It runs on the CUDA card unless ``--device cpu`` is given. ``main`` reads
the dataset and calibration from disk (``get_data``); ``run`` is the loop
and the outputs, for a dataset and calibration from anywhere.
"""
import argparse
import os
import warnings
from types import SimpleNamespace

import numpy as np
import torch


def _nhwc(img):
    """(1, 3, H, W) or (1, H, W, 3) image, array or tensor, as NHWC."""
    if img.shape[-1] in (1, 3):
        return img
    return img.permute(0, 2, 3, 1) if torch.is_tensor(img) else np.transpose(
        np.asarray(img), (0, 2, 3, 1))


def main(args, config):
    from robust_pose_tpu_torch.data.dataset_utils import get_data

    dataset, calib = get_data(args.input, config["img_size"],
                              rect_mode=config["rect_mode"])
    return run(args, config, dataset, calib)


def run(args, config, dataset, calib, timer=None):
    """The inference loop over ``dataset`` with calibration ``calib``
    (``intrinsics.left``, ``bf``), then the trajectory, the PLYs and the
    evaluation. ``timer``: a ``StageTimer`` to fill (stages ``track``,
    ``readback`` and ``loop``, the whole loop ending in a synchronize).
    Returns the output folder."""
    from robust_pose_tpu_torch.data.dataset_utils import (
        SequentialSubSampler,
        StereoVideoDataset,
        iterate_dataset,
        prefetch_iterator,
    )
    from robust_pose_tpu_torch.device import resolve_device
    from robust_pose_tpu_torch.slam.pose_estimator import PoseEstimator
    from robust_pose_tpu_torch.utils.checkpoints import load_checkpoint_any
    from robust_pose_tpu_torch.utils.evaluate import evaluate
    from robust_pose_tpu_torch.utils.logging import InferenceLogger
    from robust_pose_tpu_torch.utils.profiling import StageTimer
    from robust_pose_tpu_torch.utils.trajectory import read_freiburg, save_trajectory

    device = resolve_device(getattr(args, "device", None))
    if args.outpath is None:
        args.outpath = os.path.join(args.input, "data", "infer_trajectory")
    os.makedirs(args.outpath, exist_ok=True)

    # --device-preproc: the host thread only decodes; specularity masking,
    # resize and the rectification remap run on the device
    device_pre = None
    if getattr(args, "device_preproc", False):
        if isinstance(dataset, StereoVideoDataset):
            from robust_pose_tpu_torch.data.device_preproc import DevicePreproc
            dataset.raw = True
            device_pre = DevicePreproc(tuple(config["img_size"]),
                                       rectifier=dataset.rectify, device=device)
        else:
            warnings.warn("--device-preproc applies to video datasets "
                          "(PNG datasets are already rectified on disk); "
                          "ignored.")

    gt_file = os.path.join(args.input, "groundtruth.txt")
    gt_trajectory = read_freiburg(gt_file) if os.path.isfile(gt_file) else None
    init_pose = (gt_trajectory[args.start]
                 if gt_trajectory is not None else None)

    checkpoint = load_checkpoint_any(args.checkpoint)
    pose_estimator = PoseEstimator(
        config["slam"], np.asarray(calib["intrinsics"]["left"]),
        baseline=calib["bf"], checkpoint=checkpoint,
        img_shape=config["img_size"], init_pose=init_pose, device=device)

    if not isinstance(dataset, StereoVideoDataset):
        sampler = SequentialSubSampler(dataset, args.start, args.stop, args.step)
    else:
        warnings.warn("start/stop not supported for video dataset; ignored.",
                      UserWarning)
        sampler = None

    viewer = None
    if args.viewer == "2d":
        from robust_pose_tpu_torch.viewer.viewer2d import Viewer2D
        viewer = Viewer2D(outpath=args.outpath, blocking=args.block_viewer)
    elif args.viewer == "3d":
        try:
            from robust_pose_tpu_torch.viewer.viewer3d import Viewer3D
            viewer = Viewer3D(config["img_size"][::-1],
                              blocking=args.block_viewer)
        except ImportError as e:
            warnings.warn(f"--viewer 3d needs open3d ({e}); disabled.")
    elif args.viewer == "video":
        try:
            from robust_pose_tpu_torch.viewer.view_renderer import ViewRenderer
            viewer = ViewRenderer(config["img_size"][::-1], args.outpath)
        except ImportError as e:
            warnings.warn(f"--viewer video needs open3d ({e}); disabled.")

    recorder = InferenceLogger(log=args.log)
    recorder.set_gt(gt_trajectory)
    timer = StageTimer() if timer is None else timer

    window = max(1, getattr(args, "window", 1))
    # with a viewer or --log, a window's pass also returns its per-frame
    # flow, confidence and depth maps, read back in one bulk transfer
    diag_mode = window > 1 and (viewer is not None or args.log is not None)

    trajectory = [{"camera-pose": pose_estimator.last_pose[0],
                   "timestamp": args.start}]
    scene = None
    buf = []  # (limg, rimg, mask, img_number, i) awaiting a window dispatch

    def show(pose, scene_v, frame=None, weights=None, flow=None, idx=0,
             pcd=None):
        """Feed one frame to the viewer; returns the 3d/video viewers'
        point cloud (made here where ``pcd`` is None)."""
        if args.viewer == "2d":
            viewer(frame, weights, flow, idx)
        elif scene_v is not None:
            # 3d / video: the camera follows the pose through the surfel map
            from robust_pose_tpu_torch.viewer.viewer3d import surfels_to_open3d
            if pcd is None:
                pcd = surfels_to_open3d(scene_v.state,
                                        depth_scale=scene_v.depth_scale,
                                        stable=True)
            viewer(pose, pcd)
        return pcd

    def flush_window():
        # device-preproc outputs are on the device already: stack there
        stack = torch.stack if device_pre is not None else np.stack
        limgs = stack([b[0] for b in buf])
        rimgs = stack([b[1] for b in buf])
        masks = stack([b[2] for b in buf])
        with timer.stage("track"):
            if diag_mode:
                poses, succ, diag = pose_estimator.track_window(
                    limgs, rimgs, masks, diagnostics=True)
            else:
                poses, succ = pose_estimator.track_window(limgs, rimgs, masks)
        with timer.stage("readback"):
            poses_np = poses.cpu().numpy()
            if diag_mode:
                # one bulk transfer a window; the maps ride as f16 and
                # widen on the host
                diag = {k: v.cpu().float().numpy() for k, v in diag.items()}
        pcd = None       # a window's surfel cloud: the map after the window
        for t, (b, p) in enumerate(zip(buf, poses_np)):
            trajectory.append({"camera-pose": p[0], "timestamp": b[3]})
            if viewer is not None:
                frame_t = SimpleNamespace(img=_nhwc(b[0]),
                                          depth=diag["depth"][t:t + 1])
                pcd = show(p[0], pose_estimator.scene, frame_t,
                           (diag["conf1"][t:t + 1], diag["conf2"][t:t + 1]),
                           diag["flow"][t:t + 1], b[4] * args.step, pcd)
            if args.log is not None:
                recorder(pose_estimator.scene, p[0], step=int(b[3]))
        buf.clear()

    # decode the next frames on a background thread while the device runs
    # the current step
    defer = (viewer is None and args.log is None
             and not getattr(args, "profile", False))
    with timer.stage("loop", sync=trajectory):
        for i, data in enumerate(prefetch_iterator(
                iterate_dataset(dataset, sampler), depth=2 * window)):
            if isinstance(dataset, StereoVideoDataset):
                if device_pre is not None:
                    limg_raw, rimg_raw, pose_kinematics, img_number = data
                    limg, rimg, mask = device_pre(limg_raw, rimg_raw)
                else:
                    limg, rimg, mask, pose_kinematics, img_number = data
            else:
                limg, rimg, mask, img_number = data
            limg = limg[None] if limg.ndim == 3 else limg
            rimg = rimg[None] if rimg.ndim == 3 else rimg
            mask = mask[None] if mask.ndim == 3 else mask
            if window > 1 and i > 0:
                buf.append((limg, rimg, mask, img_number, i))
                if len(buf) == window:
                    flush_window()
                continue
            with timer.stage("track"):
                pose, scene, flow, weights = pose_estimator(limg, rimg, mask)
            # when nothing reads per-frame host data, the pose stays on the
            # device (fetched in bulk before saving): a per-frame read would
            # stall the launch queue. --profile reads it for its stage times.
            with timer.stage("readback"):
                pose_np = pose[0] if defer else pose[0].cpu().numpy()
            trajectory.append({"camera-pose": pose_np, "timestamp": img_number})
            if viewer is not None and i > 0:
                show(pose_np, scene, pose_estimator.get_frame(), weights, flow,
                     i * args.step)
            if args.log is not None and i > 0:
                recorder(scene, pose_np, step=int(img_number))
        if buf:
            flush_window()  # partial tail window
    if getattr(args, "profile", False):
        print("per-frame stages:", timer.report())
    # fetch the deferred device poses in one transfer
    on_device = [i for i, t in enumerate(trajectory)
                 if isinstance(t["camera-pose"], torch.Tensor)]
    if on_device:
        fetched = torch.stack([trajectory[i]["camera-pose"]
                               for i in on_device]).cpu().numpy()
        for i, p in zip(on_device, fetched):
            trajectory[i]["camera-pose"] = p
    save_trajectory(trajectory, args.outpath)
    if scene is not None:
        # the pool's saturation in the run summary
        n_dropped = int(scene.state.n_dropped)
        print(f"surfels: {scene.n_active} active / bucket {scene.cfg.capacity}"
              f" / cap {scene.max_capacity}; dropped appends: {n_dropped}")
        scene.save_ply(os.path.join(args.outpath, "stable_map.ply"), stable=True)
        scene.save_ply(os.path.join(args.outpath, "all_map.ply"), stable=False)

    if os.path.isfile(gt_file):
        ate_rmse, rpe_trans, rpe_rot, *_ = evaluate(
            gt_file, os.path.join(args.outpath, "trajectory.freiburg"),
            offset=-4)
        recorder.summary({"ATE/RMSE": ate_rmse, "RPE/trans": rpe_trans,
                          "RPE/rot": rpe_rot})
        print(f"ATE/RMSE: {ate_rmse:.3f} mm  RPE/trans: {rpe_trans:.3f} mm  "
              f"RPE/rot: {np.rad2deg(rpe_rot):.4f} deg")
    print("finished")
    return args.outpath


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="script to run pose estimation")
    parser.add_argument("input", type=str, help="Path to input folder.")
    parser.add_argument("--checkpoint", type=str,
                        default="../trained/poseNet_2xf8up4b.pth",
                        help="Path to trained Pose Estimator Checkpoint: a "
                        "checkpoint directory (this package's or the JAX "
                        "package's) or a reference .pth file.")
    parser.add_argument("--outpath", type=str,
                        help="Path to output folder. Defaults to input path.")
    parser.add_argument("--config", type=str,
                        default=os.path.join(os.path.dirname(__file__), "..",
                                             "..", "configuration",
                                             "infer_f2f.yaml"),
                        help="Configuration file.")
    parser.add_argument("--device", choices=["cuda", "cpu"], default=None,
                        help="device selection (default cuda; without a "
                        "card, cpu must be named).")
    parser.add_argument("--stop", type=int, default=10000000000)
    parser.add_argument("--start", type=int, default=0)
    parser.add_argument("--step", type=int, default=1)
    parser.add_argument("--log", default=None,
                        help="wandb group logging name. No logging if unset")
    parser.add_argument("--viewer", default="none",
                        choices=["none", "2d", "3d", "video"],
                        help="2d: matplotlib panels (to <outpath>/imgs); "
                        "3d, video: open3d (off where it is missing)")
    parser.add_argument("--block_viewer", action="store_true")
    parser.add_argument("--profile", action="store_true",
                        help="print per-frame stage timing")
    parser.add_argument("--window", type=int, default=1,
                        help="track N frames per batched pass (streaming "
                        "mode, f2f and f2m; use 8 for throughput)")
    parser.add_argument("--device-preproc", action="store_true",
                        dest="device_preproc",
                        help="run specularity masking, resize and the "
                        "rectification remap on the device (video "
                        "datasets): the host only decodes frames")
    return parser


if __name__ == "__main__":
    from robust_pose_tpu_torch.utils.config import read_yaml

    args = build_parser().parse_args()
    main(args, read_yaml(args.config))
