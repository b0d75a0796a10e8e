"""Per-op device time of the port's stages on one CUDA card by K chained
calls (port of ``scripts/profile_device.py``).

Each row runs one op K1 and K2 times, each call's input depending on the
last call's output through a scalar (``utils.profiling.chain_into``), and
reports (``utils.profiling.chained_row``):

- device ms a call: the profiler's summed kernel time over the K2 calls
  (``utils.profiling.device_events``) over K2;
- the host-clock slope (t(K2) - t(K1)) / (K2 - K1): what a call costs
  whichever of the host and the card sets the pace, its fixed costs
  cancelled. A row whose slope exceeds its device ms is host-bound and says
  so;
- launches a call, and the bytes ``utils.costs`` counts for one call with
  the achieved GB/s (L2 hits count as traffic: a rate, not a gate).

The nine stages, at 512x640 (``--stage all`` or a comma list):

- ``norm``: ``ops.instance_norm.instance_norm`` (K2) on bf16 NHWC maps of
  fnet's three widths at B = 4;
- ``enc``: RAFT's fnet (``models.raft.BasicEncoder``, bf16) at B = 2, 4, 8
  and 2 x ``--window`` (an f2f window's encoder batch);
- ``gru``: ``RAFT.flow_from_features``, 12 iterations through K1, at B = 2
  and 2 x ``--window``;
- ``solve``: ``solver.gauss_newton.solve_pose`` (the LM solve kernel, K3)
  at (B, iterations) = (1, 20), (8, 20), (1, 100);
- ``warp``: ``ops.warp.warp_bilinear_nearest`` and ``warp_then_eighth`` at
  B = 8;
- ``unet``: a confidence head (``models.unet.TinyUNet``, 264 channels in)
  at B = 1 and 8;
- ``prims``: the surfel primitives at a 4-frame pool (5 N rows): the
  projection, both gathers, the scatter-max winner and coverage (int32 and
  uint8), the sort and ``_seg_kmax`` winners, the rank cumsum, coverage by
  one int32 sort, by scatter-max (the two checked equal on the card) and
  by ``_seg_covered``, and the source-slot set;
- ``fuse_render``: ``slam.surfel_map.surfel_fuse_render`` on a 90 %-full
  4-frame pool, packed-key winner, ``winner`` "scatter" and "segsort" (the
  f2m default);
- ``f2m_track``: ``PoseNet.f2m_track``, 100 LM iterations.

The network stages share one PoseNet with random weights from a seeded
``torch.Generator``; inputs come from a seeded generator on the card.
``gru``, ``fuse_render`` and ``f2m_track`` run K1 // 2 (at least 2) and
K2 // 2 (at least 6) calls.

    python -m robust_pose_tpu_torch.scripts.profile_device [--stage all] \\
        [--k1 4] [--k2 20] [--window 8]

It needs a card; without one (or with ``--device cpu``) it raises.
"""
import argparse
import json

import torch

from robust_pose_tpu_torch import se3
from robust_pose_tpu_torch.ops.gather import gather_rows
from robust_pose_tpu_torch.ops.geometry import project2image
from robust_pose_tpu_torch.scripts.profile_render_decomp import FX, intrinsics
from robust_pose_tpu_torch.scripts.profile_scatter import (
    covered_bool,
    sort_winner,
    unique_set,
)
from robust_pose_tpu_torch.scripts.profile_winner_prims import (
    scatter_covered,
    scatter_winner,
)
from robust_pose_tpu_torch.slam.surfel_map import (
    _is_tail,
    _scatter_set,
    _seg_covered,
    _seg_kmax,
)
from robust_pose_tpu_torch.utils import profiling
from robust_pose_tpu_torch.utils.profiling import chain_into

H, W = 512, 640
H8, W8 = H // 8, W // 8
HEAVY = ("gru", "fuse_render", "f2m_track")   # run at half the calls
POOL_FRAMES = 4


def posenet(device):
    """The production PoseNet (bf16, 12 GRU iterations, confidence heads,
    100 LM iterations) with random weights from a seeded generator."""
    from robust_pose_tpu_torch.models.posenet import PoseNet

    model = PoseNet({"image_shape": (H, W), "iters": 12, "lbgfs_iters": 100,
                     "use_weights": True}, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.to(device)


def covered_sort(pix, m, n):
    """The per-pixel OR of the bool ``m`` by ONE int32 sort: the flag rides
    the lowest bit of ``pix << 1``, so each pixel's segment tail carries the
    OR; the tails are set with unique indices (``pix == n`` drops)."""
    s = torch.sort((pix << 1) | m.to(torch.int32)).values
    spix = s >> 1
    idx = torch.where(_is_tail(spix), spix, n)
    return _scatter_set(torch.zeros(n, dtype=torch.bool, device=pix.device),
                        idx, (s & 1) > 0)


def prims_inputs(h, w, frames, device, gen):
    """The primitives' inputs at a ``frames`` pool: points in the view
    frustum (alloc, 3), pixels in [0, n] (n drops), 30-bit keys, frame rows
    (n, 7), pool rows (alloc, 7)."""
    n = h * w
    alloc = frames * n + n
    rand = lambda *shape: torch.rand(shape, generator=gen, device=device)
    pts = rand(alloc, 3)
    z = 0.3 + 0.4 * pts[:, 2]
    opts = torch.stack([(pts[:, 0] - 0.5) * z * (w / FX),
                        (pts[:, 1] - 0.5) * z * (h / FX), z], dim=-1)
    ri = lambda hi: torch.randint(0, hi, (alloc,), generator=gen, device=device,
                                  dtype=torch.int32)
    return {"opts": opts, "pix": ri(n + 1), "key": ri(2 ** 30),
            "rows7": rand(n, 7), "pool7": rand(alloc, 7)}


def stage_prims(device, gen, _model, _window):
    n = H * W
    x = prims_inputs(H, W, POOL_FRAMES, device, gen)
    alloc = x["pix"].shape[0]
    kmat, pose = intrinsics(H, W, device), se3.identity((), device=device)
    pix, key = x["pix"], x["key"]
    m = key > 2 ** 29
    checks = {"covered_sort": torch.equal(covered_sort(pix, m, n),
                                          scatter_covered(pix, m.int(), n))}
    if not checks["covered_sort"]:
        raise RuntimeError("profile_device: covered via sort != via scatter-max")
    to_frame = torch.clamp(pix, 0, n - 1)
    to_pool = torch.clamp(pix[:n], 0, alloc - 1)
    ids = torch.arange(n, dtype=torch.int32, device=device)
    mi = m.to(torch.int32)
    return [
        (f"project2image (pool {alloc})",
         lambda c, o: project2image(chain_into(o, c), kmat, (H, W), pose),
         [(x["opts"],)]),
        (f"gather_rows pool<-frame ({alloc}x7)",
         lambda c, r, i: gather_rows(chain_into(r, c), i), [(x["rows7"], to_frame)]),
        (f"gather_rows frame<-pool ({n}x7)",
         lambda c, r, i: gather_rows(chain_into(r, c), i), [(x["pool7"], to_pool)]),
        (f"scatter-max pool->img ({alloc})",
         lambda c, p, k: scatter_winner(chain_into(p, c), k, n), [(pix, key)]),
        (f"scatter-max uint8 covered ({alloc})",
         lambda c, p, mm: covered_bool(chain_into(p, c), mm, n),
         [(pix, m.to(torch.uint8))]),
        (f"sort+set winner ({alloc})",
         lambda c, p, k: sort_winner(chain_into(p, c), k, n), [(pix, key)]),
        (f"_seg_kmax winner ({alloc})",
         lambda c, p, k: _seg_kmax(chain_into(p, c), k, n), [(pix, key)]),
        (f"cumsum rank ({alloc})",
         lambda c, mm: torch.cumsum(chain_into(mm, c), 0, dtype=torch.int32) - 1,
         [(mi,)]),
        (f"covered via 1-key sort ({alloc})",
         lambda c, p, mm: covered_sort(chain_into(p, c), mm, n), [(pix, m)]),
        (f"covered via i32 scatter-max ({alloc})",
         lambda c, p, mm: scatter_covered(chain_into(p, c), mm, n), [(pix, mi)]),
        (f"covered via _seg_covered ({alloc})",
         lambda c, p, mm: _seg_covered(chain_into(p, c), mm, n), [(to_frame, mi)]),
        ("scatter-set src (N, unique)",
         lambda c, p: unique_set(chain_into(p, c), ids, n), [(pix[:n],)]),
    ], checks


def stage_norm(device, gen, _model, _window):
    from robust_pose_tpu_torch.ops.instance_norm import instance_norm

    specs = []
    for shape in ((4, 256, 320, 64), (4, 128, 160, 96), (4, 64, 80, 128)):
        x = torch.rand(shape, generator=gen, device=device).to(torch.bfloat16)
        specs.append((f"instance_norm {shape}",
                      lambda c, x: instance_norm(chain_into(x, c)), [(x,)]))
    return specs, {}


def stage_enc(device, gen, model, window):
    from robust_pose_tpu_torch.scripts.profile_encoder import images

    return [(f"fnet encoder (batch {b})",
             lambda c, x: model.flow.fnet(chain_into(x, c)),
             [(images(b, device, seed=b),)]) for b in (2, 4, 8, 2 * window)], {}


def stage_gru(device, gen, model, window):
    specs = []
    for b in (2, 2 * window):
        feats = [torch.rand((b, H8, W8, c), generator=gen, device=device
                            ).to(torch.bfloat16) for c in (256, 256, 128, 128)]
        specs.append((f"flow_from_features 12 iters (batch {b})",
                      lambda c, f1, f2, net, inp: model.flow.flow_from_features(
                          chain_into(f1, c), f2, net, inp), [tuple(feats)]))
    return specs, {}


def stage_solve(device, gen, _model, _window):
    from robust_pose_tpu_torch.ops.geometry import create_img_coords, depth_to_pcl
    from robust_pose_tpu_torch.solver.gauss_newton import SolverConfig, solve_pose
    from robust_pose_tpu_torch.solver.objectives import PoseProblemInputs

    rand = lambda *shape: torch.rand(shape, generator=gen, device=device)
    coords = create_img_coords(H, W, device=device)
    specs = []
    for b, iters in ((1, 20), (8, 20), (1, 100)):
        k = intrinsics(H, W, device).expand(b, 3, 3).contiguous()
        pcl1 = depth_to_pcl(0.5 + 0.1 * rand(b, H, W, 1), k, coords)
        xs = PoseProblemInputs(
            flow=2.0 * rand(b, H, W, 2), pcl1=pcl1,
            pcl2=pcl1 + 0.01 * rand(b, H, W, 3), weights1=rand(b, H, W, 1),
            weights2=rand(b, H, W, 1),
            mask1=torch.ones((b, H, W, 1), dtype=torch.bool, device=device),
            mask2=torch.ones((b, H, W, 1), dtype=torch.bool, device=device),
            intrinsics=k, loss_weight=torch.ones((b, 2), device=device))
        cfg = SolverConfig(iters=iters)
        specs.append((f"GN solve (batch {b}, iters {iters})",
                      lambda c, xs, cfg=cfg: solve_pose(
                          xs._replace(flow=chain_into(xs.flow, c)), cfg),
                      [(xs,)]))
    return specs, {}


def stage_warp(device, gen, _model, _window):
    from robust_pose_tpu_torch.ops.warp import warp_bilinear_nearest, warp_then_eighth

    rand = lambda *shape: torch.rand(shape, generator=gen, device=device)
    fl = 8.0 * rand(8, H, W, 2)
    return [
        ("warp_bilinear_nearest pcl+mask (batch 8)",
         lambda c, x, m, f: warp_bilinear_nearest(chain_into(x, c), m, f),
         [(rand(8, H, W, 3), rand(8, H, W, 1), fl)]),
        ("warp_then_eighth 5ch (batch 8)",
         lambda c, x, f: warp_then_eighth(chain_into(x, c), f),
         [(rand(8, H, W, 5), fl)]),
    ], {}


def stage_unet(device, gen, model, _window):
    return [(f"TinyUNet 2d head (batch {b})",
             lambda c, x: model.weight_head_2d(chain_into(x, c)),
             [(torch.rand((b, H8, W8, 264), generator=gen, device=device),)])
            for b in (1, 8)], {}


def fuse_render_inputs(h, w, frames, device, gen):
    """(state, frame): a ``frames`` pool 90 % full of surfels in the view
    frustum, and one frame to fuse."""
    from robust_pose_tpu_torch.slam.frame import make_frame
    from robust_pose_tpu_torch.slam.surfel_map import SurfelState

    cap = frames * h * w
    alloc = cap + h * w
    rand = lambda *shape: torch.rand(shape, generator=gen, device=device)
    pts = rand(alloc, 3)
    z = 0.3 + 0.4 * pts[:, 2]
    hi = int(0.9 * cap)
    i32 = dict(dtype=torch.int32, device=device)
    st = SurfelState(
        opts=torch.stack([(pts[:, 0] - 0.5) * z * (w / FX),
                          (pts[:, 1] - 0.5) * z * (h / FX), z], dim=-1),
        rgb=255.0 * rand(alloc, 3), conf=rand(alloc),
        t_created=torch.zeros(alloc, **i32),
        active=torch.arange(alloc, device=device) < hi,
        tick=torch.tensor(3, **i32), pmat=se3.identity((), device=device),
        n_dropped=torch.zeros((), **i32), hi=torch.tensor(hi, **i32))
    fr = make_frame(255.0 * rand(1, h, w, 3), 255.0 * rand(1, h, w, 3),
                    depth=0.3 + 0.4 * rand(1, h, w, 1),
                    mask=torch.ones((1, h, w, 1), dtype=torch.bool, device=device),
                    flow=2.0 * rand(1, h, w, 2))
    return st, fr


def stage_fuse_render(device, gen, _model, _window):
    from robust_pose_tpu_torch.slam.surfel_map import SurfelConfig, surfel_fuse_render

    st, fr = fuse_render_inputs(H, W, POOL_FRAMES, device, gen)
    kmat, pose = intrinsics(H, W, device), se3.identity((), device=device)
    specs = []
    for winner in ("scatter", "segsort"):
        cfg = SurfelConfig(capacity=POOL_FRAMES * H * W, img_shape=(H, W),
                           d_thresh=0.05, average_pts=False, exact_render=False,
                           winner=winner)
        specs.append((f"surfel_fuse_render (bucket {POOL_FRAMES}xHW, {winner})",
                      lambda c, st, cfg=cfg: surfel_fuse_render(
                          st._replace(conf=chain_into(st.conf, c)), fr, pose,
                          kmat, cfg)[1].depth, [(st,)]))
    return specs, {}


def stage_f2m_track(device, gen, model, _window):
    rand = lambda *shape: torch.rand(shape, generator=gen, device=device)
    full = lambda shape, v: torch.full(shape, v, device=device)
    ones = torch.ones((1, H, W, 1), dtype=torch.bool, device=device)
    bf = lambda c: rand(1, H8, W8, c).to(torch.bfloat16)
    xs = (255.0 * rand(1, H, W, 3), full((1, H, W, 1), 0.5), ones,
          torch.zeros((1, H, W, 2), device=device), 255.0 * rand(1, H, W, 3),
          ones, intrinsics(H, W, device)[None], bf(256), bf(128), bf(128),
          full((1, H, W, 2), -16.0), full((1, H, W, 1), 0.5))
    return [("f2m_track (iters 100)",
             lambda c, ref, *rest: model.f2m_track(chain_into(ref, c), *rest).pose,
             [xs])], {}


STAGES = {"norm": stage_norm, "enc": stage_enc, "gru": stage_gru,
          "solve": stage_solve, "warp": stage_warp, "unet": stage_unet,
          "prims": stage_prims, "fuse_render": stage_fuse_render,
          "f2m_track": stage_f2m_track}
# each stage: (device, gen, model, window) -> (row specs, card-side checks)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stage", default="all",
                    help="all, or a comma list of " + ", ".join(STAGES))
    ap.add_argument("--k1", type=int, default=4)
    ap.add_argument("--k2", type=int, default=20)
    ap.add_argument("--window", type=int, default=8,
                    help="the f2f window: enc and gru run 2 x window images")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default cuda; the probe needs a card")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    want = STAGES if args.stage == "all" else tuple(args.stage.split(","))
    unknown = set(want) - set(STAGES)
    if unknown:
        raise ValueError(f"profile_device: unknown stages {sorted(unknown)}")
    device = profiling.card_device("profile_device", args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    model = (posenet(device) if set(want) & {"enc", "gru", "unet", "f2m_track"}
             else None)
    stages, checks = {}, {}
    for name, stage in STAGES.items():
        if name not in want:
            continue
        k1, k2 = ((max(2, args.k1 // 2), max(6, args.k2 // 2)) if name in HEAVY
                  else (args.k1, args.k2))
        specs, got = stage(device, gen, model, args.window)
        checks.update(got)
        stages[name] = profiling.chained_rows(specs, k1, k2)
        del specs
        torch.cuda.empty_cache()
    out = {"probe": "profile_device", **profiling.card(device),
           "k1": args.k1, "k2": args.k2, "checks": checks, "stages": stages}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
