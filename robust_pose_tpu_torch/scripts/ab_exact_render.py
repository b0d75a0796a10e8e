"""A/B: the surfel map's ``exact_render`` on and off in the f2m path, on
one CUDA card (port of ``scripts/ab_exact_render.py``).

The f2m render resolves each pixel's winning surfel either exactly
(``exact_render`` True: two passes, the highest confidence wins, bit for
bit) or in one pass with a packed key (False, the default: confidences
tie at the key's 2^-conf_bits granularity, the slot id breaks the tie;
``slam/surfel_map.py``). The reference's own tie order is that of a sort,
so neither mode is "wrong"; this measures the trade. It tracks the same
synthetic sequence (``scripts/bench.py``'s estimator and frames,
``configuration/infer_scared.yaml``: 100 LM iterations, a pool of
``--window`` frames) under both modes and prints one JSON line:

  * the largest per-frame pose-vector divergence between the modes;
  * the ATE-RMSE between the two trajectories, Horn-aligned
    (``utils/metrics.absolute_trajectory_error``, the alignment
    ``utils/evaluate`` uses);
  * each mode's streaming FPS (host clock around the replayed windows,
    ended by a read-back), with the card's name and power limit.

    python -m robust_pose_tpu_torch.scripts.ab_exact_render [--windows 4] \\
        [--window 4] [--device {cuda,cpu}]

It runs on the card unless ``--device cpu`` is given; there it prints
the poses' comparison and no FPS.
"""
import argparse
import json
import time

import numpy as np
import torch

from robust_pose_tpu_torch.scripts import bench
from robust_pose_tpu_torch.utils import profiling


def slam(exact, t_window):
    """The JAX script's f2m configuration with ``exact_render``."""
    cap = t_window * bench.H * bench.W
    return {"frame2frame": False, "lbgfs_iters": 100, "conf_weighing": True,
            "depth_clipping": [1, 250], "dist_thr": 0.05, "average_pts": False,
            "map_capacity": cap, "initial_bucket": cap, "exact_render": exact}


def run_mode(exact, n_windows=4, t_window=4, device=None, state_dict=None):
    """The first frame, ``n_windows`` windows of ``t_window`` frames (seeds
    31 on), two warm-ups (the first two windows; the first twice when
    there is one), then the same windows replayed and recorded. Returns
    (poses (n_windows * t_window, 7) of the replay, its frames a second)."""
    est = bench.build_estimator(slam(exact, t_window), device=device,
                                state_dict=state_dict)
    windows, masks = bench.start_stream(est, t_window, n_windows, seed0=31)
    for i in (0, 1):
        est.track_window(*windows[i % n_windows], masks)
    poses = []
    t0 = time.perf_counter()
    for lw, rw in windows:
        p, _ = est.track_window(lw, rw, masks)
        poses.append(p)
    flat = torch.cat(poses)[:, 0].cpu().numpy()   # the read-back ends the timing
    dt = (time.perf_counter() - t0) / (n_windows * t_window)
    return flat, 1.0 / dt


def compare(vec_on, vec_off):
    """ATE-RMSE (Horn-aligned) between the two trajectories and the largest
    pose-vector divergence."""
    from robust_pose_tpu_torch import se3
    from robust_pose_tpu_torch.utils.metrics import absolute_trajectory_error

    mats = [se3.matrix(torch.as_tensor(v, dtype=torch.float64)).numpy()
            for v in (vec_on, vec_off)]
    ate, *_ = absolute_trajectory_error(*mats)
    return float(ate), float(np.abs(vec_on - vec_off).max())


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=4)
    ap.add_argument("--window", type=int, default=4)
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default cuda; without a card, cpu must be named")
    return ap


def main(argv=None):
    from robust_pose_tpu_torch.device import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    vec_on, fps_on = run_mode(True, args.windows, args.window, device)
    vec_off, fps_off = run_mode(False, args.windows, args.window, device)
    ate, delta = compare(vec_on, vec_off)
    timed = device.type == "cuda"
    out = {"metric": "exact_render_ab_f2m", "ate_rmse_between_modes": ate,
           "max_pose_vec_delta": delta,
           "fps_exact_on": fps_on if timed else None,
           "fps_exact_off": fps_off if timed else None,
           "frames": len(vec_on), **profiling.card(device)}
    print(json.dumps(out), flush=True)
    return out, vec_on, vec_off


if __name__ == "__main__":
    main()
