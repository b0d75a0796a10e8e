"""Device profile of the port's streaming window on one CUDA card (port of
``scripts/profile_trace.py``).

Runs the bench's f2f or f2m window (``scripts/bench.py``'s estimator,
lookup "onthefly") under torch.profiler (``utils.profiling.profile_run``)
and reports

  * the card's busy ms a frame (the union of its kernels, copies and
    memsets) and its idle share of the wall time;
  * the kernel time by group (``utils.profiling.KERNEL_GROUPS``: the hand
    kernels K1-K7, convolutions and products, elementwise passes, ...);
  * the top kernels by self time, each with its group.

The card has no hardware byte counters that torch.profiler reads. In
their place the same windows are run once more under ``utils.costs``
(untimed): the counted GB a frame and FLOPs, and the achieved GB/s and
TFLOP/s over the busy time (the byte model counts L2 hits as traffic).

    python -m robust_pose_tpu_torch.scripts.profile_trace [--path f2f|f2m] \\
        [--window 8] [--windows 2] [--top 25] [--json out.json]

It needs a card: device times come only from one, and without a card (or
with ``--device cpu``) it raises.
"""
import argparse
import json

from robust_pose_tpu_torch.scripts import bench, roofline
from robust_pose_tpu_torch.utils import costs, profiling

SPANS = {"f2f": "infer_window.", "f2m": ("f2m_", "fuse_render")}


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", default="f2f", choices=["f2f", "f2m"])
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default cuda; the profile needs a card")
    return ap


def profile_path(path, device, window, n_windows, pool_frames=None, top=12):
    """``n_windows`` windows of ``path`` after the first frame and two
    warm-ups: once under a counter, once under the profiler. Returns
    (profile_run's result, the Counter, the estimator)."""
    est = roofline.estimator(path, device, pool_frames)
    windows, masks = bench.start_stream(est, window, n_windows + 2,
                                        roofline.SEED0[path])
    for i in (-1, -2):
        est.track_window(*windows[i], masks)
    with costs.count() as counter:
        for w in windows[:n_windows]:
            est.track_window(*w, masks)

    def run():
        for w in windows[:n_windows]:
            est.track_window(*w, masks)

    return profiling.profile_run(run, SPANS[path], top), counter, est


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = profiling.card_device("profile_trace", args.device)
    prof, counter, _ = profile_path(args.path, device, args.window, args.windows,
                                    top=args.top)
    frames = args.window * args.windows
    busy = prof["device_busy_ms"]
    groups = dict(sorted(((g, ms / frames) for g, ms in prof["group_ms"].items()),
                         key=lambda kv: -kv[1]))
    out = {"path": args.path, "window": args.window, "windows": args.windows,
           **profiling.card(device),
           "device_ms_per_frame": busy / frames,
           "wall_ms_per_frame": prof["wall_ms"] / frames,
           "idle_share": prof["idle_share"],
           "launches_per_frame": prof["kernel_launches"] / frames,
           "group_ms_per_frame": groups,
           "group_ms_sum_over_busy": sum(prof["group_ms"].values()) / busy,
           "counted_gb_per_frame": counter.bytes / frames / 1e9,
           "counted_gflops_per_frame": counter.flops / frames / 1e9,
           "achieved_gb_per_s": counter.bytes / 1e9 / (busy / 1e3),
           "achieved_tflop_per_s": counter.flops / 1e12 / (busy / 1e3),
           "top_kernels": [[name[:96], ms / frames, profiling.kernel_group(name)]
                           for name, ms in prof["top_kernels_ms"]]}
    print(f"device time: {out['device_ms_per_frame']} ms/frame over {frames} "
          f"frames, idle share {out['idle_share']} ({out['device']}, "
          f"{out['power_limit']})")
    print(f"counted traffic: {out['counted_gb_per_frame']} GB/frame, "
          f"{out['achieved_gb_per_s']} GB/s over the busy time")
    print("\n-- by group (ms a frame) --")
    for g, ms in groups.items():
        print(f"  {g:34s} {ms:10.4f}  ({100 * ms * frames / busy:5.1f}%)")
    print(f"\n-- top {args.top} kernels by self time (ms a frame) --")
    for name, ms, group in out["top_kernels"]:
        print(f"  {ms:9.4f}  [{group[:26]:26s}] {name}")
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({**out, "profile": prof}, f)
    return out


if __name__ == "__main__":
    main()
