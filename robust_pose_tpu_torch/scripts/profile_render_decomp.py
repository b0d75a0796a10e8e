"""The surfel render's device milliseconds phase by phase on one CUDA card
(port of ``scripts/profile_render_decomp.py``).

A render of the f2m pool moves ~100 MB, a few hundredths of a millisecond
at the card's memory rate; so where its milliseconds go is a question of
which primitive owns them. Each phase of the render (and of the fuse's
scatters) runs here alone, over the port's own functions, at a ``--frames``
pool (capacity frames x N slots and one frame of margin, N = 327,680 pixels
at 512x640):

1. ``ops.geometry.project2image`` of the pool;
2. the key pack (``slam.surfel_map._pack``);
3. the scatter-max winner;
4. the (alloc, 7) pool table (``torch.cat``);
5. the winner gather (``ops.gather.gather_rows``) as one 7-channel table;
   5b. the same split 3 + 3 + 1;
6. the output assembly (``_winner_frame``'s elementwise tail);
7. the pixel calc (valid mask and pixel index);
8. the covered and winner scatter pair; 8b. the same as one 2-column
   scatter; 8c. N updates only; 8c'. 2, 4 and 8 chained chunks
   (``profile_warp4.scatter_max_chunked``); 8c''. coherent, near-raster
   pixels; 8d. the sort winner (``winner: "sort"``); 8e. the f2m default,
   ``_seg_kmax``.

Each phase cycles through ``--iters`` input batches drawn apart (so no
batch is still in the L2 from the call before) and is timed by
``utils.profiling.chained_row`` over iters and 2 x iters chained calls:
device ms, host slope, launches a call, counted bytes and GB/s. The JAX
script subtracts a measured dispatch floor from every row (its rows are
host-clock times of a remote device); the profiler's device time here has
no such floor, so nothing is subtracted. Before timing the card checks,
and raises on a mismatch, that the fused scatter equals the two-pass one,
each chunked chain the single scatter, and the sort and ``_seg_kmax``
winners the scatter-max.

    python -m robust_pose_tpu_torch.scripts.profile_render_decomp \\
        [--frames 4] [--iters 8]

It needs a card; without one (or with ``--device cpu``) it raises.
"""
import argparse
import json

import torch

from robust_pose_tpu_torch import se3
from robust_pose_tpu_torch.ops.gather import gather_rows
from robust_pose_tpu_torch.ops.geometry import project2image
from robust_pose_tpu_torch.scripts.profile_scatter import scatter_max_rows, sort_winner
from robust_pose_tpu_torch.scripts.profile_warp4 import scatter_max_chunked
from robust_pose_tpu_torch.scripts.profile_winner_prims import scatter_winner
from robust_pose_tpu_torch.slam.surfel_map import (
    _pack,
    _scatter_max,
    _seg_kmax,
    _slot_bits,
)
from robust_pose_tpu_torch.utils import profiling
from robust_pose_tpu_torch.utils.profiling import chain_into

H, W = 512, 640
FX = 500.0
CHUNKS = (2, 4, 8)


def intrinsics(h, w, device):
    return torch.tensor([[FX, 0.0, w / 2], [0.0, FX, h / 2], [0.0, 0.0, 1.0]],
                        device=device)


def pool_batch(h, w, frames, device, gen):
    """One input batch of the phases at a ``frames`` pool: points in the
    view frustum, pixels in [0, n] (n drops), keys (-1 on dropped rows),
    a slot image in [-1, alloc), confidences, colours, 0/1 matched flags,
    winner rows (n, 7) and coherent pixels (the raster plus -2..2)."""
    n = h * w
    alloc = frames * n + n
    rand = lambda *shape: torch.rand(shape, generator=gen, device=device)
    ri = lambda lo, hi, m: torch.randint(lo, hi, (m,), generator=gen,
                                         device=device, dtype=torch.int32)
    pts = rand(alloc, 3)
    z = 0.3 + 0.4 * pts[:, 2]
    opts = torch.stack([(pts[:, 0] - 0.5) * z * (w / FX),
                        (pts[:, 1] - 0.5) * z * (h / FX), z], dim=-1)
    pix = ri(0, n + 1, alloc)
    raster = torch.arange(n, dtype=torch.int32, device=device).repeat(
        alloc // n + 1)[:alloc]
    return {"opts": opts, "pix": pix,
            "key": torch.where(pix < n, ri(0, 2 ** 30, alloc), -1),
            "slot_img": ri(-1, alloc, n), "conf": rand(alloc),
            "rgb": 255.0 * rand(alloc, 3),
            "matched": (rand(alloc) < 0.5).to(torch.int32),
            "win": rand(n, 7),
            "coherent": torch.clamp(raster + ri(-2, 3, alloc), 0, n - 1)}


def pack_keys(conf, valid):
    """Phase 2: the packed ``(quantized conf << slot_bits) | slot`` keys."""
    alloc = conf.shape[0]
    ids = torch.arange(alloc, dtype=torch.int32, device=conf.device)
    return _pack(conf, ids, valid, _slot_bits(alloc))


def pool_table(opts, rgb, conf):
    """Phase 4: the (alloc, 7) table the winner gather reads."""
    return torch.cat([opts, rgb, conf[:, None]], dim=-1)


def winner_gather(tbl, slot_img):
    return gather_rows(tbl, torch.clamp(slot_img, 0, tbl.shape[0] - 1))


def winner_gather_split(opts, rgb, conf, slot_img):
    sl = torch.clamp(slot_img, 0, opts.shape[0] - 1)
    return gather_rows(opts, sl), gather_rows(rgb, sl), gather_rows(conf, sl)


def assemble(win, slot_img, h, w):
    """Phase 6: (rgb, depth, confidence) images from the winners' (n, 7)
    rows under the identity view, 0 where a pixel has none."""
    have = slot_img >= 0
    conf_img = torch.where(have, win[:, 6], 0.0)
    zcam = se3.act(se3.identity((1,), device=win.device), win[:, :3])[:, 2]
    depth_img = torch.where(have, zcam, 0.0)
    rgb_img = torch.where(have[:, None], win[:, 3:6], 0.0)
    return (rgb_img.reshape(1, h, w, 3), depth_img.reshape(1, h, w, 1),
            conf_img.reshape(1, h, w, 1))


def pixel_calc(ipts, inb, active, h, w):
    """Phase 7: each row's pixel, n where it drops."""
    valid = inb & active
    px = torch.clamp(ipts[:, 0].to(torch.int32), 0, w - 1)
    py = torch.clamp(ipts[:, 1].to(torch.int32), 0, h - 1)
    return torch.where(valid, py * w + px, h * w)


def two_scatters(pix, key, matched, n):
    """Phase 8: the covered and the winner scatter-max, one after the other."""
    dev = pix.device
    cov = _scatter_max(torch.zeros(n, dtype=torch.int32, device=dev), pix, matched)
    return cov, scatter_winner(pix, key, n)


def fused_scatter(pix, key, matched, n):
    """Phase 8b: the same two results from one (n, 2) scatter-max."""
    init = torch.tensor([[0, -1]], dtype=torch.int32, device=pix.device)
    out = scatter_max_rows(init.expand(n, 2), pix,
                           torch.stack([matched, key], dim=-1))
    return out[:, 0], out[:, 1]


def check(b, n):
    """The card-side checks on one batch: {name: equal}."""
    pix, key = b["pix"], b["key"]
    cov, win = two_scatters(pix, key, b["matched"], n)
    fcov, fwin = fused_scatter(pix, key, b["matched"], n)
    out = {"fused_two_pass": torch.equal(fcov, cov) and torch.equal(fwin, win),
           "sort_winner": torch.equal(sort_winner(pix, key, n), win),
           "seg_kmax": torch.equal(_seg_kmax(pix, key, n), win)}
    for k in CHUNKS:
        out[f"chunked_{k}"] = torch.equal(scatter_max_chunked(pix, key, n, k), win)
    return out


def row_specs(batches, h, w, frames):
    """(name, fn(c, *xs), [xs of each batch]) of each phase."""
    n = h * w
    alloc = frames * n + n
    dev = batches[0]["pix"].device
    kmat, pose = intrinsics(h, w, dev), se3.identity((), device=dev)
    active = torch.arange(alloc, device=dev) < frames * n
    on = lambda *keys: [tuple(b[k] for k in keys) for b in batches]
    inb = [b["pix"] < n for b in batches]
    valid = [(b["conf"], v) for b, v in zip(batches, inb)]
    tables = [(pool_table(b["opts"], b["rgb"], b["conf"]), b["slot_img"])
              for b in batches]
    first_n = [(b["pix"][:n], b["key"][:n]) for b in batches]
    specs = [
        ("1. project2image (alloc pts)",
         lambda c, o: project2image(chain_into(o, c), kmat, (h, w), pose),
         on("opts")),
        ("2. key pack (elementwise alloc)",
         lambda c, cf, v: pack_keys(chain_into(cf, c), v), valid),
        ("3. scatter-max winner (alloc->N)",
         lambda c, p, k: scatter_winner(chain_into(p, c), k, n), on("pix", "key")),
        ("4. pool-table concat (alloc, 7)",
         lambda c, o, r, cf: pool_table(chain_into(o, c), r, cf),
         on("opts", "rgb", "conf")),
        ("5. winner gather (N rows of 7ch)",
         lambda c, t, s: winner_gather(t, chain_into(s, c)), tables),
        ("5b. winner gather (split 3+3+1)",
         lambda c, o, r, cf, s: winner_gather_split(o, r, cf, chain_into(s, c)),
         on("opts", "rgb", "conf", "slot_img")),
        ("6. output assembly (N elementwise)",
         lambda c, wn, s: assemble(chain_into(wn, c), s, h, w),
         on("win", "slot_img")),
        ("7. pix calc (elementwise alloc)",
         lambda c, o, v: pixel_calc(chain_into(o, c), v, active, h, w),
         [(b["opts"], v) for b, v in zip(batches, inb)]),
        ("8. two scatter-maxes (covered + winner)",
         lambda c, p, k, m: two_scatters(chain_into(p, c), k, m, n),
         on("pix", "key", "matched")),
        ("8b. fused 2-col scatter-max",
         lambda c, p, k, m: fused_scatter(chain_into(p, c), k, m, n),
         on("pix", "key", "matched")),
        ("8c. scatter-max winner (N updates only)",
         lambda c, p, k: scatter_winner(chain_into(p, c), k, n), first_n),
    ]
    for k in CHUNKS:
        specs.append((f"8c'. scatter-max winner (chained {k} chunks)",
                      lambda c, p, kk, k=k: scatter_max_chunked(
                          chain_into(p, c), kk, n, k), on("pix", "key")))
    specs += [
        ("8c''. scatter-max winner (coherent idx)",
         lambda c, p, k: scatter_winner(chain_into(p, c), k, n),
         on("coherent", "key")),
        ("8d. sort-based winner (pool)",
         lambda c, p, k: sort_winner(chain_into(p, c), k, n), on("pix", "key")),
        ("8e. _seg_kmax winner (pool)",
         lambda c, p, k: _seg_kmax(chain_into(p, c), k, n), on("pix", "key")),
    ]
    return specs


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=4, help="pool capacity in frames")
    ap.add_argument("--iters", type=int, default=8,
                    help="input batches a phase cycles through")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default cuda; the probe needs a card")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = profiling.card_device("profile_render_decomp", args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    batches = [pool_batch(H, W, args.frames, device, gen)
               for _ in range(args.iters)]
    checks = check(batches[0], H * W)
    if not all(checks.values()):
        raise RuntimeError(f"profile_render_decomp: {checks}")
    print(f"fused == two-pass, chunked == single, sort == scatter: {checks}",
          flush=True)
    rows = profiling.chained_rows(row_specs(batches, H, W, args.frames),
                                  args.iters, 2 * args.iters)
    out = {"probe": "profile_render_decomp", "frames": args.frames,
           "iters": args.iters, **profiling.card(device), "checks": checks,
           "rows": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
