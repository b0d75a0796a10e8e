"""FLOP / byte roofline of the port's hot paths on one CUDA card (port of
``scripts/roofline.py``; ``--by-op`` lists the per-op attribution of the
naive bytes, ``scripts/hlo_bytes.py`` that of the corrected ones).

For each path it runs the production code (``scripts/bench.py``'s
estimator, the same ``track_window`` the bench times) once under
``utils.costs.count`` -- untimed: every aten op's FLOPs and bytes, and
each hand kernel's own formula -- and then times it: two warm-up windows,
then ``--windows`` windows by the host clock, ended by
``torch.cuda.synchronize()``. From these it reports

  * MFU = realized FLOP/s over the bf16 peak (989e12, H100 SXM, dense);
  * device-memory utilization = counted bytes a second over 3.35e12;
  * the binding resource (the larger lower bound: each dtype's FLOPs over
    its own peak, or the bytes over the memory rate) and the overhead
    (measured time less that bound),

so "is this fast?" has a first-principles answer, and the yardstick reads
the same work whatever implements a kernel (the CPU counts what the card
counts).

Paths: the f2f window (``configuration/infer_f2f.yaml``'s solver
settings, ``--window`` frames, lookup "onthefly": K1, as "auto" resolves
on a card), the f2m window (``infer_scared.yaml``, 100 LM iterations, 4
frames, the pool sized as ``bench.py`` sizes it) and, with ``--train``,
the training step (``bench_train_step.build`` at batch 8, remat, 2
microbatches, RAFT live through the lane-wise lookup: K4/K5; per sample).

Byte model, and its limit: each op's operands and outputs are traffic
(``utils/costs``), so a tensor that stays in the 50 MB L2 between two ops
counts twice and ``hbm_util_pct`` can read above 100 %. The ``_corrected``
keys read the same run in the corrected model (gathers read what they
emit, in-place scatters touch what they index; ``scripts/hlo_bytes.py``).
Every number is printed unrounded, with the card's name and power limit.

    python -m robust_pose_tpu_torch.scripts.roofline [--train] [--skip-f2m] \\
        [--window 8] [--windows 6] [--by-op 20] [--json rows.json] \\
        [--device {cuda,cpu}]

It runs on the card unless ``--device cpu`` is given; there it prints the
counts with ``null`` times (no CPU time is printed as a device's).
"""
import argparse
import json
import time

import torch

from robust_pose_tpu_torch.scripts import bench
from robust_pose_tpu_torch.utils import costs, profiling

F2M_WINDOW = 4            # the f2m path's window, as the JAX script's
TRAIN_BATCH = 8
TRAIN_ACCUM = 2


SEED0 = {"f2f": 1, "f2m": 11}   # the bench's first window seeds


def estimator(path, device, pool_frames=None):
    """The bench's estimator of ``path`` ("f2f" or "f2m", its pool of
    ``pool_frames`` frames), with lookup "onthefly": the lookup "auto"
    takes on a card, so the CPU counts the card's work."""
    slam = bench.F2F_SLAM if path == "f2f" else bench.f2m_slam(pool_frames)
    return bench.build_estimator(slam, device=device, lookup="onthefly")


def count_window(path, device, window, pool_frames=None):
    """One window of ``path`` ("f2f" or "f2m", its pool of ``pool_frames``
    frames, default the bench's) under a counter, from a fresh estimator
    after its first frame: the same work whenever it is called (the same
    weights, frames and estimator state). Returns the Counter."""
    est = estimator(path, device, pool_frames)
    windows, masks = bench.start_stream(est, window, 1, SEED0[path])
    with costs.count() as c:
        est.track_window(*windows[0], masks)
    _sync(device)
    return c


def time_windows(path, device, window, n_windows):
    """Seconds a frame of ``path``: a fresh estimator, its first frame, two
    warm-up windows, then ``n_windows`` windows by the host clock, ended
    by ``torch.cuda.synchronize()``."""
    est = estimator(path, device)
    windows, masks = bench.start_stream(est, window, n_windows + 2, SEED0[path])
    for i in (-1, -2):
        est.track_window(*windows[i], masks)
    _sync(device)
    t0 = time.perf_counter()
    for i in range(n_windows):
        est.track_window(*windows[i], masks)
    _sync(device)
    return (time.perf_counter() - t0) / (n_windows * window)


def train_step(device):
    """The training path: a trainer (bench_train_step.build at batch 8,
    remat, 2 microbatches, RAFT live through the lane-wise lookup), its
    state and two batches."""
    from robust_pose_tpu_torch.scripts import bench_train_step as bts

    trainer, state = bts.build(TRAIN_BATCH, remat=True, accum=TRAIN_ACCUM,
                               stop_flow_grad=False, device=device,
                               lookup="lanewise")
    batches = [bts.make_batch(TRAIN_BATCH, k, device) for k in (2, 3)]
    return trainer, state, batches


def count_train(device):
    trainer, state, batches = train_step(device)
    with costs.count() as c:
        trainer.train_step(state, batches[0])
    _sync(device)
    return c


def time_train(device, n_steps):
    trainer, state, batches = train_step(device)
    for i in range(2):
        trainer.train_step(state, batches[i])
    _sync(device)
    t0 = time.perf_counter()
    for i in range(n_steps):
        trainer.train_step(state, batches[i % 2])
    _sync(device)
    return (time.perf_counter() - t0) / (n_steps * TRAIN_BATCH)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def row(tag, counter, frames, seconds, card):
    """The JAX script's row for ``frames`` frames (or samples) of counted
    work and ``seconds`` a frame (None: not timed)."""
    f = counter.flops / frames
    b = counter.bytes / frames
    t_c = counter.compute_s() / frames
    t_h = b / costs.HBM_BYTES_PER_S
    b_corr = counter.bytes_corrected / frames
    out = {"path": tag, "gflops_per_frame": f / 1e9, "hbm_gb_per_frame": b / 1e9,
           "measured_ms_per_frame": None if seconds is None else seconds * 1e3,
           "compute_bound_ms": t_c * 1e3, "hbm_bound_ms": t_h * 1e3,
           "mfu_pct": None, "hbm_util_pct": None,
           "binding_resource": "compute" if t_c >= t_h else "HBM",
           "overhead_ms": None, **card, "frames": frames,
           "flops": counter.flops, "bytes": counter.bytes,
           "gflops_per_frame_by_dtype": {k: v[0] / frames / 1e9
                                         for k, v in sorted(counter.by_dtype.items())
                                         if v[0]},
           "hbm_gb_per_frame_corrected": b_corr / 1e9,
           "hbm_util_pct_corrected": None}
    if seconds is not None:
        out.update(mfu_pct=100.0 * f / seconds / costs.BF16_FLOPS,
                   hbm_util_pct=100.0 * b / seconds / costs.HBM_BYTES_PER_S,
                   overhead_ms=(seconds - max(t_c, t_h)) * 1e3,
                   hbm_util_pct_corrected=100.0 * b_corr / seconds
                   / costs.HBM_BYTES_PER_S)
    return out


def by_op(tag, counter, n):
    """``--by-op``: the top ``n`` ops by bytes and by FLOPs, and the spans."""
    return {"path": tag, "top_by_bytes": counter.top(n, "bytes"),
            "top_by_flops": counter.top(n, "flops"),
            "spans": counter.summary()["by_span"]}


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", action="store_true",
                    help="include the training step (batch 8, remat)")
    ap.add_argument("--skip-f2m", action="store_true")
    ap.add_argument("--json", help="write the rows to this file")
    ap.add_argument("--window", type=int, default=8, help="f2f window")
    ap.add_argument("--windows", type=int, default=6,
                    help="timed windows (training steps: half, at least 2)")
    ap.add_argument("--by-op", type=int, default=0, metavar="N",
                    help="also print the top N ops by bytes and by FLOPs")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default cuda; without a card, cpu must be named")
    return ap


def main(argv=None):
    from robust_pose_tpu_torch.device import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    timed = device.type == "cuda"
    card = profiling.card(device)
    jobs = [("f2f_window", "f2f", args.window)]
    if not args.skip_f2m:
        jobs.append(("f2m_window_iters100", "f2m", F2M_WINDOW))
    rows, extra = [], []
    for tag, path, window in jobs:
        c = count_window(path, device, window)
        sec = time_windows(path, device, window, args.windows) if timed else None
        rows.append(row(tag, c, window, sec, card))
        extra.append(by_op(tag, c, args.by_op))
        print(json.dumps(rows[-1]), flush=True)
        _free(device)
    if args.train:
        c = count_train(device)
        sec = time_train(device, max(2, args.windows // 2)) if timed else None
        rows.append(row(f"train_step_batch{TRAIN_BATCH}", c, TRAIN_BATCH, sec, card))
        extra.append(by_op(rows[-1]["path"], c, args.by_op))
        print(json.dumps(rows[-1]), flush=True)
        _free(device)
    if args.by_op:
        for e in extra:
            print(json.dumps(e), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


def _free(device):
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
