"""Per-stage device time of the frame-to-model window at production shape
on one CUDA card (port of ``scripts/profile_f2m.py``).

Profiles the bench's f2m window (512x640, ``configuration/infer_scared.yaml``:
100 LM iterations; a surfel pool pre-sized to ``--frames`` x H x W
slots) on the card's timeline (``utils.profiling.profile_run``) and reads
its spans: the batched ``f2m_precompute`` (the window's encoders and
stereo flow), the per-frame ``f2m_track.{encode,flow,weights,solve}``
against the rendered reference, and the surfel map's ``fuse_render``.
Each carries its device ms, kernel ms, host ms and launches a frame, and
the FLOPs and bytes ``utils.costs`` counts for it in a run of the same
windows, with the achieved TFLOP/s and GB/s.

    python -m robust_pose_tpu_torch.scripts.profile_f2m [--frames 4] \\
        [--iters 8] [--stage all|precompute|track|fuse_render|solve|...] \\
        [--window 8]

``--iters``: the windows profiled (after the first frame and two
warm-ups); ``--stage`` keeps the spans whose name holds it. It needs a
card; without one (or with ``--device cpu``) it raises.
"""
import argparse
import json

from robust_pose_tpu_torch.scripts import bench
from robust_pose_tpu_torch.scripts.profile_stages import per_frame
from robust_pose_tpu_torch.scripts.profile_trace import profile_path
from robust_pose_tpu_torch.utils import profiling


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=bench.F2M_POOL_FRAMES,
                    help="pool bucket in frames (capacity = frames * H * W)")
    ap.add_argument("--iters", type=int, default=8, help="windows profiled")
    ap.add_argument("--stage", default="all")
    ap.add_argument("--window", type=int, default=bench.F2M_WINDOW)
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default cuda; the profile needs a card")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = profiling.card_device("profile_f2m", args.device)
    prof, counter, est = profile_path("f2m", device, args.window, args.iters,
                                      pool_frames=args.frames)
    frames = args.window * args.iters
    stages = per_frame(profiling.span_rates(prof, counter), frames)
    if args.stage != "all":
        stages = {k: v for k, v in stages.items() if args.stage in k}
    out = {"path": "f2m", "window": args.window, "windows": args.iters,
           "pool_frames": args.frames, **profiling.card(device),
           "device_ms_per_frame": prof["device_busy_ms"] / frames,
           "idle_share": prof["idle_share"],
           "n_active": est.scene.n_active, "stages_per_frame": stages}
    for name, r in stages.items():
        print(f"{name:24s} {r['device_ms']:9.4f} ms/frame device "
              f"{r['kernel_ms']:9.4f} kernel {r['host_ms']:9.4f} host  "
              f"{r.get('achieved_tflop_per_s')} TFLOP/s "
              f"{r.get('achieved_gb_per_s')} GB/s")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
