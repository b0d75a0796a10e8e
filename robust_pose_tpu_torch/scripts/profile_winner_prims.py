"""The surfel map's winner primitives on one CUDA card (port of
``scripts/profile_winner_prims.py``): scatter-max against the double-sort
segment pipeline, at the f2m pool's shape.

The port's surfel map picks each pixel's winner (the max of a packed key
over the pool rows that project onto it) and its coverage (the OR of a
matched flag) by one of three modes (``slam/surfel_map.py``): one
``scatter_reduce`` (amax), or sorts. f2m runs ``segsort``: ``_seg_kmax``
sorts the (pixel, key) pair packed into int64 (``_sort_pairs``), moves each
pixel's segment tail to the front with an int32 sort and writes the first
N rows; ``_seg_covered`` does the same with the flag in the key's lowest
bit, two int32 sorts. Which costs the card less is what each pair of rows
answers, at ``--rows`` candidate rows (default $ROWS, else 5 N: a 4-frame
pool and one frame of margin, 1,638,400 rows at 512x640) into N = 327,680
pixels.

First the card checks, and raises on a mismatch: ``_seg_kmax`` equals the
scatter-max winner, ``_seg_covered`` on clipped pixels equals the
scatter-max coverage, and the appended block's extension over unique
ascending pixels (a gather, a max and a set) equals the unhinted
scatter-max. Then the rows (``utils.profiling.chained_row``: device ms,
host slope, launches a call, counted bytes and GB/s):

- winner: scatter-max, ``_seg_kmax``;
- covered: scatter-max, ``_seg_covered``;
- the extension, N rows: scatter-max, gather-max-set;
- the stages of ``_seg_kmax``: the int64 pair sort (``_sort_pairs``), a
  one-operand int32 sort.

    python -m robust_pose_tpu_torch.scripts.profile_winner_prims [--rows R]

It needs a card; without one (or with ``--device cpu``) it raises.
"""
import argparse
import json
import os

import torch

from robust_pose_tpu_torch.slam.surfel_map import (
    _scatter_max,
    _scatter_set,
    _seg_covered,
    _seg_kmax,
    _sort_pairs,
)
from robust_pose_tpu_torch.utils import profiling
from robust_pose_tpu_torch.utils.profiling import chain_into

H, W = 512, 640
N = H * W
ALLOC = 4 * N + N             # a 4-frame pool and one frame of margin
K1, K2 = 3, 9                 # chained calls of the two timings


def winner_inputs(rows, n, device, gen):
    """(pix, key, mat, blk_pix, blk_key): ``rows`` candidates on pixels
    [0, n] (n drops) with 30-bit keys and 0/1 flags; the appended block,
    n rows whose first half-or-so hold unique ascending pixels and the
    rest the sentinel n, with their keys."""
    ri = lambda lo, hi, m: torch.randint(lo, hi, (m,), generator=gen,
                                         device=device, dtype=torch.int32)
    pix, key, mat = ri(0, n + 1, rows), ri(0, 2 ** 30, rows), ri(0, 2, rows)
    placed = torch.rand(n, generator=gen, device=device) < 0.5
    ids = torch.nonzero(placed).flatten().to(torch.int32)
    blk_pix = torch.full((n,), n, dtype=torch.int32, device=device)
    blk_pix[:ids.numel()] = ids
    return pix, key, mat, blk_pix, ri(0, 2 ** 30, n)


def scatter_winner(pix, key, n):
    """The per-pixel max of ``key`` by one scatter-max, -1 where none."""
    return _scatter_max(torch.full((n,), -1, dtype=torch.int32,
                                   device=pix.device), pix, key)


def scatter_covered(pix, flag, n):
    """The per-pixel OR of the 0/1 ``flag`` by one scatter-max."""
    return _scatter_max(torch.zeros(n, dtype=torch.int32, device=pix.device),
                        pix, flag) > 0


def extend_unique(base, pix, key, n):
    """``base.at[pix].max(key, mode="drop")`` for unique ``pix`` in [0, n)
    and sentinel rows ``pix == n``: gather, max, set (what XLA's unique
    and sorted hints allow)."""
    cur = base[torch.clamp(pix, max=n - 1).long()]
    return _scatter_set(base, pix, torch.maximum(cur, key))


def check(pix, key, mat, blk_pix, blk_key, n):
    """The card-side checks: {name: equal}."""
    ref_w = scatter_winner(pix, key, n)
    pixc = torch.clamp(pix, max=n - 1)      # the coverage pass clips
    return {
        "winner": torch.equal(_seg_kmax(pix, key, n), ref_w),
        "covered": torch.equal(_seg_covered(pixc, mat, n),
                               scatter_covered(pixc, mat, n)),
        "extension": torch.equal(extend_unique(ref_w, blk_pix, blk_key, n),
                                 _scatter_max(ref_w, blk_pix, blk_key)),
    }


def row_specs(pix, key, mat, blk_pix, blk_key, n):
    """(name, fn(c, *xs), [xs]) of each row."""
    pixc = torch.clamp(pix, max=n - 1)
    base = scatter_winner(pix, key, n)
    return [
        ("winner: scatter-max",
         lambda c, p, k: scatter_winner(chain_into(p, c), k, n), [(pix, key)]),
        ("winner: _seg_kmax",
         lambda c, p, k: _seg_kmax(chain_into(p, c), k, n), [(pix, key)]),
        ("covered: scatter-max",
         lambda c, p, m: scatter_covered(chain_into(p, c), m, n), [(pixc, mat)]),
        ("covered: _seg_covered",
         lambda c, p, m: _seg_covered(chain_into(p, c), m, n), [(pixc, mat)]),
        ("ext: scatter-max N rows",
         lambda c, p, k: _scatter_max(base, chain_into(p, c), k),
         [(blk_pix, blk_key)]),
        ("ext: gather-max-set N rows (unique pixels)",
         lambda c, p, k: extend_unique(base, chain_into(p, c), k, n),
         [(blk_pix, blk_key)]),
        ("  int64 pair sort (_sort_pairs, rows)",
         lambda c, p, k: _sort_pairs(chain_into(p, c), k), [(pix, key)]),
        ("  one-operand int32 sort (rows)",
         lambda c, p, m: torch.sort((chain_into(p, c) << 1) | m).values,
         [(pix, mat)]),
    ]


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=int(os.environ.get("ROWS", ALLOC)),
                    help="candidate rows (default $ROWS, else 5 x 512 x 640)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default cuda; the probe needs a card")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = profiling.card_device("profile_winner_prims", args.device)
    xs = winner_inputs(args.rows, N, device,
                       torch.Generator(device=device).manual_seed(0))
    print(f"rows={args.rows} targets={N}", flush=True)
    checks = check(*xs, N)
    if not all(checks.values()):
        raise RuntimeError(f"profile_winner_prims: the segment pipeline differs "
                           f"from scatter-max: {checks}")
    print("correctness: segment pipeline == scatter (winner/covered/ext)",
          flush=True)
    rows = profiling.chained_rows(row_specs(*xs, N), K1, K2)
    out = {"probe": "profile_winner_prims", "rows_in": args.rows, "targets": N,
           **profiling.card(device), "checks": checks, "rows": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
