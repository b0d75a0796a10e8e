"""Static device-memory byte attribution of the shipped tracking windows
(port of ``scripts/hlo_bytes.py``).

Counts one window of the bench's estimator (``scripts/bench.py``; the same
window ``scripts/roofline.py`` counts: a fresh estimator, its first frame,
then the window) under ``utils.costs.count`` and prints the two byte
models side by side:

  * naive: every op's operands plus its outputs (what ``roofline.py``
    charges; its f2f utilization is read against this);
  * corrected: gathers read only what they emit (plus their indices, at
    most their table once), in-place scatters read their indices and
    updates and read and write only the touched elements; out-of-place
    scatters keep the naive charge, since eager PyTorch copies their
    whole base first (XLA scatters into a donated buffer: there the JAX
    script's rule and this one differ); every other op, the hand kernels
    included, as the naive model charges it.

The rules and their limits are ``utils/costs``'s module docstring: a tensor
that stays in the 50 MB L2 is still charged on every use, and reads below
the 32-byte sector undercount. ``--measure-bw`` times the copy rate the card
reaches (``y = x + 1`` over 1 GiB of f32, far past the L2; CUDA events
around 8 launches after a warm-up; 2 x 4 bytes an element), to read the
utilization against beside the data sheet's 3.35e12 B/s.

Paths: f2f, ``configuration/infer_f2f.yaml``'s settings (``bench.F2F_SLAM``,
20 LM iterations), ``--window`` frames; f2m, ``configuration/
infer_scared.yaml`` (``bench.f2m_slam``, 100 LM iterations) with the pool
sized to ``--window`` frames, as the JAX script sizes it.

    python -m robust_pose_tpu_torch.scripts.hlo_bytes [--path f2f|f2m] \\
        [--top 30] [--window 8] [--frame-ms MS] [--measure-bw] \\
        [--device {cuda,cpu}]

It runs on the card unless ``--device cpu`` is given; there it counts, and
``--measure-bw`` refuses (no CPU time is printed as a device's). The last
line is one JSON object with every number unrounded, the card's name and
power limit, and both by-op tables; ``main(argv)`` returns it.
"""
import argparse
import json

import torch

from robust_pose_tpu_torch.scripts import roofline
from robust_pose_tpu_torch.utils import costs, profiling

COPY_GIB = 1.0            # the copy's f32 array, far past the 50 MB L2
COPY_REPS = 8             # timed launches


def measure_copy_bw(device, gib=COPY_GIB, reps=COPY_REPS):
    """The copy rate the card reaches, bytes a second (read plus write):
    ``y = x + 1`` over ``gib`` GiB of f32, two warm-up launches, then
    ``reps`` chained launches between CUDA events."""
    n = int(gib * (1 << 30)) // 4
    y = torch.zeros(n, dtype=torch.float32, device=device)
    for _ in range(2):
        y = y + 1.0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        y = y + 1.0
    end.record()
    end.synchronize()
    seconds = start.elapsed_time(end) / 1e3 / reps
    del y
    torch.cuda.empty_cache()
    return 2 * n * 4 / seconds


def report(args, counter, card, bw):
    """The JAX script's lines, then the JSON object (returned)."""
    frames = args.window
    naive, corr = counter.bytes, counter.bytes_corrected
    out = {"tool": "hlo_bytes", "path": args.path, "window": args.window,
           "pool_frames": args.window if args.path == "f2m" else None,
           **card, "naive_bytes": naive, "corrected_bytes": corr,
           "naive_gb_per_frame": naive / frames / 1e9,
           "corrected_gb_per_frame": corr / frames / 1e9,
           "frame_ms": args.frame_ms, "peak_bytes_per_s": costs.HBM_BYTES_PER_S,
           "measured_bytes_per_s": bw,
           "bound_ms_per_frame": corr / frames / costs.HBM_BYTES_PER_S * 1e3,
           "bound_ms_per_frame_measured": (None if bw is None
                                           else corr / frames / bw * 1e3),
           "util_pct": None, "util_pct_naive": None, "util_pct_measured": None}
    if bw is not None:
        print(f"measured copy rate: {bw / 1e9:.0f} GB/s (read+write)")
    print(f"naive operand+output bytes : {naive / 1e9:8.2f} GB "
          f"({naive / frames / 1e9:.2f} GB/frame)")
    print(f"corrected byte estimate    : {corr / 1e9:8.2f} GB "
          f"({corr / frames / 1e9:.2f} GB/frame)")
    if args.frame_ms:
        need = out["bound_ms_per_frame"]
        out["util_pct"] = 100.0 * need / args.frame_ms
        out["util_pct_naive"] = (100.0 * naive / frames / costs.HBM_BYTES_PER_S
                                 * 1e3 / args.frame_ms)
        print(f"bytes-bound time @ {costs.HBM_BYTES_PER_S / 1e9:.0f} GB/s peak: "
              f"{need:.3f} ms/frame; measured {args.frame_ms:.3f} ms/frame "
              f"-> utilization {out['util_pct']:.1f}% "
              f"(naive {out['util_pct_naive']:.1f}%)")
        if bw is not None:
            need2 = out["bound_ms_per_frame_measured"]
            out["util_pct_measured"] = 100.0 * need2 / args.frame_ms
            print(f"@ measured copy rate {bw / 1e9:.0f} GB/s: {need2:.3f} "
                  f"ms/frame -> utilization {out['util_pct_measured']:.1f}%")
    by_op = sorted(counter.corrected_by_op.items(), key=lambda kv: -kv[1][0])
    print("\n-- by op (corrected; naive beside it) --")
    for op, (b, calls) in by_op[:15]:
        print(f"  {op:24s} {b / 1e9:8.3f} GB  ({100.0 * b / max(corr, 1):4.1f}%)"
              f"  naive {counter.by_op[op][1] / 1e9:8.3f} GB  x{calls}")
    rows = counter.top_corrected(args.top)
    print(f"\n-- top {args.top} rows (corrected, xN = calls) --")
    for span, op, sig, b, calls in rows:
        print(f"  {b / 1e6:9.1f} MB  x{calls:<5d} {op:18s} {span[:28]:28s} "
              f"{sig[:80]}")
    out.update(
        by_op_naive={k: list(v) for k, v in sorted(counter.by_op.items())},
        by_op_corrected={k: list(v) for k, v in sorted(counter.corrected_by_op.items())},
        by_span_corrected=dict(sorted(counter.corrected_by_span.items())),
        top_rows=rows)
    return out


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", default="f2f", choices=["f2f", "f2m"])
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--window", type=int, default=8,
                    help="frames a window; the f2m pool holds as many")
    ap.add_argument("--frame-ms", type=float, default=None,
                    help="measured ms a frame for the utilization row")
    ap.add_argument("--measure-bw", action="store_true",
                    help="also measure the copy rate the card reaches")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default cuda; without a card, cpu must be named")
    return ap


def main(argv=None):
    from robust_pose_tpu_torch.device import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.measure_bw and device.type != "cuda":
        raise RuntimeError(f"--measure-bw times the card's copy rate: it needs a "
                           f"CUDA device, and prints no rate for {device}")
    bw = measure_copy_bw(device) if args.measure_bw else None
    counter = roofline.count_window(
        args.path, device, args.window,
        pool_frames=args.window if args.path == "f2m" else None)
    out = report(args, counter, profiling.card(device), bw)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
