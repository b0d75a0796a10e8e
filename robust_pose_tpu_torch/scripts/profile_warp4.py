"""Does splitting one large row gather, or one large scatter-max, into
serialized chunks pay on the card? (Port of ``scripts/profile_warp4.py``.)

The JAX package chunks its gathers (``ops/gather.py``) for a TPU lowering
problem; the port's ``ops/gather.gather_rows`` takes the chunk as an
argument and gathers whole by default. These rows time the same work whole
and in S chunks issued one after another on one stream, at the shapes of
the two hot gather sites and of the pool's winner scatter (512x640, N =
327,680 pixels):

- the fuse-like gather: 5 N = 1,638,400 rows of 32 B from an (N, 8) f32
  table, S = 1, 4, 8, 16, 32;
- the warp-like gather: N rows of 64 B from a (513 x 641, 16) f32 table,
  S = 1, 4, 8, 16;
- the scatter-max of 5 N int32 keys into N pixels, S = 1, 4, 8, 16 chunks
  chained on one target;
- both gathers whole again from the same table less its last column (rows
  of 28 B and 60 B, the same indices): does a row width that is a multiple
  of 16 B change how PyTorch's gather runs?

Before timing the card checks, and raises on a mismatch, that every
chunked result equals the whole one bit for bit. Each row is
``utils.profiling.chained_row``'s: device ms, host slope, launches a call,
counted bytes and GB/s.

    python -m robust_pose_tpu_torch.scripts.profile_warp4

It needs a card; without one (or with ``--device cpu``) it raises.
"""
import argparse
import json

import torch

from robust_pose_tpu_torch.ops.gather import gather_rows
from robust_pose_tpu_torch.utils import profiling
from robust_pose_tpu_torch.utils.profiling import chain_into

H, W = 512, 640
N = H * W
M = (H + 1) * (W + 1)
K1, K2 = 3, 9                 # chained calls of the two timings
FUSE_CHUNKS = (1, 4, 8, 16, 32)
WARP_CHUNKS = (1, 4, 8, 16)
SCATTER_CHUNKS = (1, 4, 8, 16)


def chunk_rows(n, s):
    """The ``chunk`` argument of ``gather_rows`` for ``s`` chunks of n rows."""
    return None if s == 1 else -(-n // s)


def gather_inputs(rows, table_rows, cols, device, gen):
    """(table (table_rows, cols) f32 in [0, 1), idx (rows,) int32)."""
    tbl = torch.rand((table_rows, cols), generator=gen, device=device)
    idx = torch.randint(0, table_rows, (rows,), generator=gen, device=device,
                        dtype=torch.int32)
    return tbl, idx


def scatter_max_chunked(pix, key, n, s):
    """``full(n, -1).at[pix].max(key, mode="drop")`` (``pix`` in [0, n])
    as ``s`` scatter-maxes of consecutive row chunks into one target."""
    out = torch.full((n + 1,), -1, dtype=torch.int32, device=pix.device)
    step = -(-pix.shape[0] // s)
    for j in range(0, pix.shape[0], step):
        out.scatter_reduce_(0, pix[j:j + step].long(), key[j:j + step],
                            reduce="amax")
    return out[:-1]


def check(fuse, warp, scat, n):
    """Every chunked result against the whole one: {name: equal}."""
    out = {}
    for name, (tbl, idx), chunks in (("fuse", fuse, FUSE_CHUNKS),
                                     ("warp", warp, WARP_CHUNKS)):
        whole = gather_rows(tbl, idx)
        for s in chunks[1:]:
            out[f"{name}_gather_{s}"] = torch.equal(
                gather_rows(tbl, idx, chunk_rows(idx.shape[0], s)), whole)
    whole = scatter_max_chunked(*scat, n, 1)
    for s in SCATTER_CHUNKS[1:]:
        out[f"scatter_max_{s}"] = torch.equal(scatter_max_chunked(*scat, n, s),
                                              whole)
    return out


def row_specs(fuse, warp, scat, n):
    """(name, fn(c, *xs), [xs]) of each row."""
    specs = []
    for what, (tbl, idx), chunks in (
            ("fuse-like gather 1.6M rows x 32B", fuse, FUSE_CHUNKS),
            ("warp-like gather 327k rows x 64B", warp, WARP_CHUNKS)):
        for s in chunks:
            ch = chunk_rows(idx.shape[0], s)
            specs.append((f"{what}, chunks={s}",
                          lambda c, t, i, ch=ch: gather_rows(t, chain_into(i, c), ch),
                          [(tbl, idx)]))
    for what, (tbl, idx) in (("fuse-like gather 1.6M rows x 28B", fuse),
                             ("warp-like gather 327k rows x 60B", warp)):
        specs.append((f"{what}, chunks=1",
                      lambda c, t, i: gather_rows(t, chain_into(i, c)),
                      [(tbl[:, :-1].contiguous(), idx)]))
    for s in SCATTER_CHUNKS:
        specs.append((f"scatter-max 1.6M -> 327k int32, chunks={s}",
                      lambda c, p, k, s=s: scatter_max_chunked(
                          chain_into(p, c), k, n, s), [scat]))
    return specs


def warp4_inputs(device, gen):
    """The three workloads at 512x640: (fuse, warp, (pix, key))."""
    fuse = gather_inputs(5 * N, N, 8, device, gen)
    warp = gather_inputs(N, M, 16, device, gen)
    pix = torch.randint(0, N + 1, (5 * N,), generator=gen, device=device,
                        dtype=torch.int32)
    key = torch.randint(0, 2 ** 30, (5 * N,), generator=gen, device=device,
                        dtype=torch.int32)
    return fuse, warp, (pix, key)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default cuda; the probe needs a card")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = profiling.card_device("profile_warp4", args.device)
    xs = warp4_inputs(device, torch.Generator(device=device).manual_seed(0))
    checks = check(*xs, N)
    if not all(checks.values()):
        raise RuntimeError(f"profile_warp4: chunked != whole: {checks}")
    rows = profiling.chained_rows(row_specs(*xs, N), K1, K2)
    out = {"probe": "profile_warp4", **profiling.card(device),
           "checks": checks, "rows": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
