"""The readings that the limits of ``correct`` are set from, on the card at
a cell's own size, many seeds in one process:

- ``program``: the numbers compared, the program against the reference
  (the lower readings), after a short window at the cell's own load;
- ``control``: the reference computed with its bfloat16 operands rounded
  to float8 (e4m3, one scale a tensor), put in the program's place, against
  the float32 reference (the upper readings); for a tracking window's pose
  solve (``solve_pose``), the reference's solve of the program's stage
  outputs with its normal equations built in bfloat16 against the same
  solve in float32;
- for a training cell, ``half_batch``: the reference stepping on the first
  half of each batch (the mean taken over it) against the whole batch's.
  A state left unchanged reads 1 by construction and needs no run.

    python3 -m port_bench.control --workload <name> --seeds 1 2 ... \\
        [--control-seeds 3] [--seconds 3]

One JSON line a seed. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from port_bench import cells, compare
from port_bench.reference.model import fake_quant
from port_bench.run import cache_env


def _as_program(ref: dict) -> dict:
    """A reference window's outputs in the layout the program returns."""
    nhwc = lambda x: x.permute(0, 2, 3, 1)
    out = {k: nhwc(ref[k]) for k in ("time_flow", "stereo_flow", "depth",
                                      "conf1", "conf2")}
    out.update(pose=ref["pose"], success=ref["success"], poses=ref["poses"])
    return out


def _worst_leaves(prog, ref, n=4):
    keep = compare.kept_leaves(ref["first_update"])
    return {k: [[round(g, 6), leaf, p, r] for g, leaf, p, r in
                compare.leaf_rows(prog[k], ref[k], keep)[:n]]
            for k in ("first_update", "change")}


def readings(workload, seed, seconds, device, root, control, overrides=None,
             f32_witness=False):
    """The readings of one seed (see the module doc). ``f32_witness``: also
    the program run with float32 convolutions (``mixed_precision`` off)
    against the reference, a second witness of what the configuration's
    bfloat16 alone moves."""
    bench = cells.benchmark(root)
    cell = cells.load_cell(bench, workload, seed, device, overrides)
    drv = cells.generator(cell)
    drv.setup(seconds)
    out = {"seed": seed}
    if cell.mix["generator"] == "stream":
        drv.window(seconds)
        drv.release()
        rows, ctl = [], []
        for it in drv.checked:
            ref = drv.reference(it)
            rows.append(drv.numbers(it, ref))
            if control:
                low = drv.reference(it, q=fake_quant())
                ctl.append(dict(
                    compare.window_numbers(_as_program(low), ref, it["start"],
                                           drv.scale),
                    solve_pose=compare.solve_gap(drv.solve(it, torch.bfloat16),
                                                 drv.solve(it))))
        out["program"] = compare.worst(rows)
        if control:
            out["control"] = compare.worst(ctl)
    else:
        drv.release()
        ref = drv.reference()
        out["program"] = compare.train_numbers(drv.prog, ref)
        out["worst_leaves"] = _worst_leaves(drv.prog, ref)
        if f32_witness:
            model = dict(cell.cfg["model"], mixed_precision=False)
            ov = dict(overrides or {})
            ov["cfg"] = dict(ov.get("cfg", {}), model=model)
            wit = cells.generator(cells.load_cell(bench, workload, seed, device, ov))
            wit.setup(seconds)
            wit.release()
            out["f32_program"] = compare.train_numbers(wit.prog, ref)
            out["f32_worst_leaves"] = _worst_leaves(wit.prog, ref)
        if control:
            out["control"] = compare.train_numbers(
                drv.reference(q=fake_quant()), ref)
            n = cell.mix["check_steps"]
            half = [tuple(x[:x.shape[0] // 2] for x in b) for b in drv.batches[:n]]
            out["half_batch"] = compare.train_numbers(
                drv.reference(batches=half), ref)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--f32-witness-seeds", type=int, default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    cache_env(root)
    if not torch.cuda.is_available():
        print("port_bench.control: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        r = readings(args.workload, seed, args.seconds, torch.device("cuda", 0),
                     root, i < args.control_seeds,
                     f32_witness=i < args.f32_witness_seeds)
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
