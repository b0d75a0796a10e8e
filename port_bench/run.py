"""Run one cell of the benchmark once and print its result line.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. A fresh process
loads the program (``robust_pose_tpu_torch``), makes the cell's inputs and
weights on the card from the seed, warms up, measures for ``--seconds``
and, with ``--trace 1``, traces a slice of further work for the per-layer
metrics. Then it frees the program, runs the plain reference over the
outputs it kept and prints, as the last lines of standard error, each
number compared beside its limit, and as the last line of standard output
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``.

It refuses to run (exit 2, no result) without a CUDA device, and fails
(exit 3, no result) if JAX, flax or the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "robust_pose_tpu")


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own kernels build into ``build/`` there already)."""
    os.environ["USE_FLAX"] = "0"
    for key, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[key] = str(root / "build" / "port_bench" / sub)


def forbidden_modules(modules=None):
    """Modules loaded (``sys.modules`` unless given) whose top-level name is
    JAX's, flax's or the JAX package's, compared whole:
    ``robust_pose_tpu_torch`` is not ``robust_pose_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def device_block(device, trace_slice=None) -> dict:
    import torch

    if device.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": 1,
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if trace_slice is not None:
        out["busy_s"] = trace_slice.busy_s()
        out["window_s"] = trace_slice.wall_s
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, root: Path, overrides=None, faults=None) -> dict:
    """One run of one cell on ``device``; returns the result object.
    ``faults(generator)`` may break the program under test before it first
    runs (the tests' planted faults)."""
    import torch

    from port_bench import cells, flops
    from port_bench import profile as prof

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = cells.benchmark(root)
    cell = cells.load_cell(bench, workload, seed, device, overrides)
    drv = cells.generator(cell)
    if device.type == "cuda":
        torch.empty(1, device=device)          # the context, before its stats
        torch.cuda.reset_peak_memory_stats(device)
    drv.setup(seconds, faults)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T0
    values = drv.window(seconds)
    values["setup_s"] = setup_s
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in cell.end_to_end}
    result = {"correct": False, "attempted": drv.attempted,
              "failed": getattr(drv, "failed", 0)}
    breakdown, sl = None, None
    if trace:
        sl = prof.capture(drv.trace_fn()) if device.type == "cuda" else None
        run = {"trace": sl, "host": drv.host, "rate": drv.rate,
               "cfg": cell.cfg, "work": drv.work(), "flops": flops}
        metrics = {}
        for m in cell.per_layer:
            v = cells.metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if sl is not None:
            breakdown = {"device_ops": sl.top_ops(10),
                         "idle_gaps": sl.idle_gaps(10)}
    result["metrics"] = metrics
    result["device"] = device_block(device, sl)
    drv.release()
    numbers = drv.check()
    # the numbers the limits file bounds are compared; the others are
    # readings only (PERF.md says why each is not compared)
    checks = {k: [numbers.get(k, math.nan), lim]
              for k, lim in cell.limits.items()}
    result["correct"] = bool(checks) and all(
        math.isfinite(v) and v <= lim for v, lim in checks.values())
    result["readings"] = {k: v for k, v in numbers.items() if k not in checks}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    cache_env(root)
    import torch

    from port_bench import cells

    bench = cells.benchmark(root)
    w = next((c for c in bench["workloads"] if c["name"] == args.workload), None)
    if w is None:
        print(f"port_bench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"port_bench: {w['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "found", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), root)
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, v in result.pop("readings").items():
        print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
    for k, (v, lim) in result["checks"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
