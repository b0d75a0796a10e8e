"""Scatter-side rows of the surfel map's winner passes on one CUDA card
(port of ``scripts/profile_scatter.py``).

What sets a winner scatter's cost on the card: its payload width (can the
coverage flag ride the winner scatter as a second column?), its update
count (N and 5 N updates into N = 327,680 pixels: one frame and a 4-frame
pool with its margin, at 512x640), and the sort-based winner beside it
(the surfel map's ``winner: "sort"``: one int64 sort of the (pixel, key)
pair, then a set of each pixel's segment tail). At each count:

- scatter-max with a 1-column payload, and with a 2-column one (the key
  and ``key > 0``, ``scatter_reduce`` amax on an (N, 2) target);
- the sort + tail-set winner;
- the unique-index set (``_scatter_set``, as the fuse builds its source
  slots; with more updates than pixels which write lands is unspecified,
  as under the JAX ``unique_indices`` hint: a timing only);

then the one-byte coverage scatter-max at 5 N. Before the rows of a count the
card checks, and raises on a mismatch, that the 2-column result's key
column equals the 1-column result and that sort + tail-set equals
scatter-max. Each row is ``utils.profiling.chained_row``'s: device ms,
host slope, launches a call, counted bytes and GB/s.

    python -m robust_pose_tpu_torch.scripts.profile_scatter

It needs a card; without one (or with ``--device cpu``) it raises.
"""
import argparse
import json

import torch

from robust_pose_tpu_torch.scripts.profile_winner_prims import scatter_winner
from robust_pose_tpu_torch.slam.surfel_map import (
    SurfelConfig,
    _scatter_max,
    _scatter_set,
    _winner_kmax,
)
from robust_pose_tpu_torch.utils import profiling
from robust_pose_tpu_torch.utils.profiling import chain_into

H, W = 512, 640
N = H * W
K1, K2 = 3, 9                 # chained calls of the two timings
_SORT = SurfelConfig(capacity=1, img_shape=(1, 1), winner="sort")


def scatter_inputs(upd, n, device, gen):
    """(pix, key): ``upd`` updates on pixels [0, n] (n drops), 30-bit keys."""
    ri = lambda lo, hi: torch.randint(lo, hi, (upd,), generator=gen,
                                      device=device, dtype=torch.int32)
    return ri(0, n + 1), ri(0, 2 ** 30)


def scatter_max_rows(base, pix, vals):
    """``base.at[pix].max(vals, mode="drop")`` for an (n, C) ``base``, (U,)
    ``pix`` in [0, n] and (U, C) ``vals``: one ``scatter_reduce`` (amax)."""
    out = torch.cat([base, base[:1]])
    out.scatter_reduce_(0, pix.long()[:, None].expand(-1, base.shape[1]),
                        vals, reduce="amax")
    return out[:-1]


def winner_2col(pix, key, n):
    """(n, 2): the winner key and the OR of ``key > 0``, one scatter."""
    payload = torch.stack([key, (key > 0).to(torch.int32)], dim=-1)
    return scatter_max_rows(torch.full((n, 2), -1, dtype=torch.int32,
                                       device=pix.device), pix, payload)


def sort_winner(pix, key, n):
    """The surfel map's ``winner: "sort"``."""
    return _winner_kmax(pix, key, n, _SORT)


def unique_set(pix, ids, n):
    return _scatter_set(torch.zeros(n, dtype=torch.int32, device=pix.device),
                        pix, ids)


def covered_bool(pix, m, n):
    """The per-pixel OR of a one-byte flag ``m`` (uint8 0/1) by one
    scatter-max: the bool scatter of the JAX script (CUDA's scatter_reduce
    takes no bool)."""
    return _scatter_max(torch.zeros(n, dtype=torch.uint8, device=pix.device),
                        pix, m) > 0


def check(pix, key, n):
    """The card-side checks at one update count: {name: equal}."""
    one = scatter_winner(pix, key, n)
    return {"2col_key_column": torch.equal(winner_2col(pix, key, n)[:, 0], one),
            "sort_tail_set": torch.equal(sort_winner(pix, key, n), one)}


def row_specs(pix, key, n):
    """(name, fn(c, *xs), [xs]) of the rows at one update count."""
    upd = pix.shape[0]
    ids = torch.arange(upd, dtype=torch.int32, device=pix.device) % n
    tag = f"({upd // n}N updates)"
    return [
        (f"scatter-max 1ch {tag}",
         lambda c, p, k: scatter_winner(chain_into(p, c), k, n), [(pix, key)]),
        (f"scatter-max 2ch {tag}",
         lambda c, p, k: winner_2col(chain_into(p, c), k, n), [(pix, key)]),
        (f"sort+tail-set winner {tag}",
         lambda c, p, k: sort_winner(chain_into(p, c), k, n), [(pix, key)]),
        (f"unique set {tag}",
         lambda c, p: unique_set(chain_into(p, c), ids, n), [(pix,)]),
    ]


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default cuda; the probe needs a card")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = profiling.card_device("profile_scatter", args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    checks, rows = {}, []
    for upd in (N, 5 * N):
        pix, key = scatter_inputs(upd, N, device, gen)
        got = check(pix, key, N)
        if not all(got.values()):
            raise RuntimeError(f"profile_scatter: {upd} updates: {got}")
        checks.update({f"{k}_{upd // N}N": v for k, v in got.items()})
        rows += profiling.chained_rows(row_specs(pix, key, N), K1, K2)
    pix, _ = scatter_inputs(5 * N, N, device, gen)
    m = torch.randint(0, 2, (5 * N,), generator=gen, device=device,
                      dtype=torch.uint8)
    rows += profiling.chained_rows(
        [("covered uint8 scatter-max (5N updates)",
          lambda c, p, mm: covered_bool(chain_into(p, c), mm, N), [(pix, m)])],
        K1, K2)
    out = {"probe": "profile_scatter", "targets": N, **profiling.card(device),
           "checks": checks, "rows": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
