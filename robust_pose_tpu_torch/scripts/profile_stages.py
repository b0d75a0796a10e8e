"""Per-stage device time of the f2f window at production shape on one
CUDA card (port of ``scripts/profile_stages.py``).

The JAX script timed each stage of ``PoseNet.infer`` as its own jitted
program. The port runs eagerly, so it profiles the production window
itself (``PoseNet.infer_window`` through the bench's estimator, 512x640,
``configuration/infer_f2f.yaml``'s solver settings) and reads its spans,
``infer_window.{encode,flow,weights,solve}``, off the card's timeline
(``utils.profiling.profile_run``): each stage's device ms (its window on
the timeline), kernel ms, host ms and launches, a frame. In place of
XLA's cost analysis each stage carries the FLOPs and bytes that
``utils.costs`` counts for its span in a run of the same windows, and the
achieved TFLOP/s and GB/s over the stage's device ms.

    python -m robust_pose_tpu_torch.scripts.profile_stages [--iters 8] \\
        [--stage all|encode|flow|weights|solve] [--window 8]

``--iters``: the windows profiled (after the first frame and two
warm-ups). It needs a card; without one (or with ``--device cpu``) it
raises.
"""
import argparse
import json

from robust_pose_tpu_torch.scripts.profile_trace import profile_path
from robust_pose_tpu_torch.utils import profiling

STAGES = ("encode", "flow", "weights", "solve")


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=8, help="windows profiled")
    ap.add_argument("--stage", default="all", choices=("all",) + STAGES)
    ap.add_argument("--window", type=int, default=8,
                    help="T for the infer_window stage")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default cuda; the profile needs a card")
    return ap


def per_frame(rates, frames):
    """``span_rates`` rows with their ms, GB and GFLOP a frame."""
    out = {}
    for name, r in rates.items():
        row = dict(r)
        for k in ("device_ms", "kernel_ms", "host_ms", "launches", "gb", "gflop"):
            if k in row:
                row[k] = row[k] / frames
        out[name] = row
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = profiling.card_device("profile_stages", args.device)
    prof, counter, _ = profile_path("f2f", device, args.window, args.iters)
    frames = args.window * args.iters
    stages = per_frame(profiling.span_rates(prof, counter), frames)
    if args.stage != "all":
        stages = {k: v for k, v in stages.items()
                  if k == f"infer_window.{args.stage}"}
    out = {"path": "f2f", "window": args.window, "windows": args.iters,
           **profiling.card(device),
           "device_ms_per_frame": prof["device_busy_ms"] / frames,
           "idle_share": prof["idle_share"], "stages_per_frame": stages}
    for name, r in stages.items():
        print(f"{name:24s} {r['device_ms']:9.4f} ms/frame device "
              f"{r['kernel_ms']:9.4f} kernel {r['host_ms']:9.4f} host  "
              f"{r.get('achieved_tflop_per_s')} TFLOP/s "
              f"{r.get('achieved_gb_per_s')} GB/s")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
