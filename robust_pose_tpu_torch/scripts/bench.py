"""Streaming tracking throughput on one CUDA card (port of the root
``bench.py``).

Drives ``PoseEstimator.track_window``, the streaming API that
``scripts/infer_trajectory.py`` uses, so the figure holds the whole
production path: the batched temporal and stereo RAFT flow (12 GRU
iterations), disparity to depth, the flow warps, the TinyUNet confidence
heads, the LM pose solve with its ``|log(rel)| > 0.1`` failure branch,
pose chaining and the frame carry. Shape 512x640, ``lbgfs_iters`` 20
(``configuration/infer_f2f.yaml``).

A second figure, frame-to-model FPS at ``configuration/infer_scared.yaml``'s
100 LM iterations (``f2m_fps_iters100``), rides in the same line: render
from the surfel map, track and fuse a frame, the pool carried.

Frames are shifted crops of a blurred random texture (correlated like real
video, so tracking succeeds and the fuse path stays engaged), staged on
the device as uint8 before timing. Weights are random, from a seeded
``torch.Generator``, with the flow head set to emit the sequence's
disparity::

    python -m robust_pose_tpu_torch.scripts.bench [--device {cuda,cpu}]

It runs on the card unless ``--device cpu`` is given. It prints one JSON
line, ``{"metric", "value", "unit", "vs_baseline", ...}``, where
``vs_baseline`` is FPS / 30 (the 30 FPS real-time mark).
"""
import argparse
import json
import os
import time

import numpy as np
import torch

H, W = 512, 640
FX = 500.0
# the model of configuration/infer_f2f.yaml's checkpoint: 12 GRU iterations,
# confidence heads, 3 UNet levels, bf16 mixed precision
MODEL = {"iters": 12, "use_weights": True, "unet_levels": 3,
         "mixed_precision": True}
# window-size overrides for sweeps (defaults are the shipped configuration)
F2F_WINDOW = int(os.environ.get("BENCH_F2F_WINDOW", 8))
F2M_WINDOW = int(os.environ.get("BENCH_F2M_WINDOW", 8))
# f2m pool capacity in frames, apart from the window length: the pool pass
# costs what its bucket holds, so window-length comparisons keep the pool
F2M_POOL_FRAMES = int(os.environ.get("BENCH_F2M_POOL_FRAMES", 4))

# frame-to-frame, configuration/infer_f2f.yaml
F2F_SLAM = {
    "frame2frame": True, "lbgfs_iters": 20, "conf_weighing": True,
    "depth_clipping": [1, 250], "dist_thr": 0.05, "average_pts": False,
}


def f2m_slam(pool_frames=None, winner=None):
    """Frame-to-model, configuration/infer_scared.yaml (100 LM
    iterations). The pool is pre-sized to its cap, ``pool_frames`` frames
    (F2M_POOL_FRAMES): the synthetic sequence appends at every frame
    (random-weight confidences defeat the depth-match test), so every pool
    pass costs the full capacity. ``winner``: the packed-winner primitive
    (slam/surfel_map.py), default $BENCH_F2M_WINNER, else segsort."""
    cap = (F2M_POOL_FRAMES if pool_frames is None else pool_frames) * H * W
    return {
        "frame2frame": False, "lbgfs_iters": 100, "conf_weighing": True,
        "depth_clipping": [1, 250], "dist_thr": 0.05, "average_pts": False,
        "map_capacity": cap, "initial_bucket": cap,
        "winner": winner or os.environ.get("BENCH_F2M_WINNER", "segsort"),
    }


def make_sequence(n_frames, disparity=8, step=3, seed=0):
    """Shifted crops of one blurred random texture: a horizontally
    translating stereo camera with constant disparity (depth = fx*B/d).
    Returns uint8 (T, 1, H, W, 3) left and right frames."""
    rng = np.random.default_rng(seed)
    pad = disparity + step * n_frames + 8
    base = rng.uniform(0.0, 255.0, (H + 16, W + pad, 3)).astype(np.float32)
    # separable box blur for smooth image gradients
    k = 9
    c = np.cumsum(np.pad(base, ((k, k), (0, 0), (0, 0)), mode="edge"), axis=0)
    base = (c[2 * k:] - c[:-2 * k]) / (2 * k)
    c = np.cumsum(np.pad(base, ((0, 0), (k, k), (0, 0)), mode="edge"), axis=1)
    base = (c[:, 2 * k:] - c[:, :-2 * k]) / (2 * k)
    base = base[:H + 16]

    def crop(dx):
        return base[8:8 + H, dx:dx + W]

    ls = np.stack([crop(step * i)[None] for i in range(n_frames)])
    rs = np.stack([crop(step * i + disparity)[None] for i in range(n_frames)])
    return ls.astype(np.uint8), rs.astype(np.uint8)


def build_estimator(slam_cfg, disparity=8, early_exit=True, state_dict=None,
                    device=None, lookup=None):
    """A ``PoseEstimator`` for ``slam_cfg`` at (H, W) with MODEL's network.
    Weights: ``state_dict`` where given, else random from
    ``torch.Generator().manual_seed(0)``. Either way the flow head's last
    convolution is zeroed and biased so that every GRU iteration emits the
    sequence's constant disparity / 12: untrained RAFT's flow is near
    random, which would leave depth invalid, the f2m rendering half empty
    and the failure branch skipping every fuse. The compute is the same;
    depth is valid everywhere and every production path stays engaged.
    ``lookup``: RAFT's lookup (default $BENCH_LOOKUP, else "auto")."""
    from robust_pose_tpu_torch.device import resolve_device
    from robust_pose_tpu_torch.models.posenet import PoseNet
    from robust_pose_tpu_torch.slam.pose_estimator import PoseEstimator

    device = resolve_device(device)
    model_cfg = dict(MODEL, image_shape=(H, W),
                     lbgfs_iters=slam_cfg["lbgfs_iters"],
                     # benchmark-floor switch: False runs every LM iteration
                     # to the cap (no data-dependent early exit)
                     solver_early_exit=early_exit,
                     lookup=lookup or os.environ.get("BENCH_LOOKUP", "auto"))
    if state_dict is None:
        model = PoseNet(model_cfg, device="cpu")
        model.reset_parameters(torch.Generator().manual_seed(0))
        state_dict = model.state_dict()
    K = np.array([[FX, 0.0, W / 2], [0.0, FX, H / 2], [0.0, 0.0, 1.0]],
                 np.float32)
    est = PoseEstimator(slam_cfg, K, 16.0,
                        {"state_dict": state_dict, "config": {"model": model_cfg}},
                        (W, H), device=device)
    head = est.model.flow.update["update_block"].flow_head.conv2
    with torch.no_grad():
        head.weight.zero_()
        head.bias.copy_(torch.tensor([-disparity / (8.0 * 12), 0.0]))
    return est


def start_stream(est, t_window, n_windows, seed0=1):
    """Feed ``est`` the first frame (``make_sequence(1)``) and stage
    ``n_windows`` windows of ``t_window`` frames (seeds ``seed0`` on) on
    its device as uint8. Returns (windows [(left, right)], masks)."""
    device = est.device
    ls, rs = make_sequence(1)
    est(ls[0], rs[0], np.ones((1, H, W, 1), bool))
    masks = torch.ones((t_window, 1, H, W, 1), dtype=torch.bool, device=device)
    windows = []
    for i in range(n_windows):
        ls, rs = make_sequence(t_window, seed=seed0 + i)
        windows.append((torch.from_numpy(ls).to(device),
                        torch.from_numpy(rs).to(device)))
    return windows, masks


def bench_stream(est, t_window, n_windows, seed0=1, diagnostics=False,
                 fetch_diag=True):
    """Feed the first frame on its own, then time ``n_windows``
    ``track_window`` calls of ``t_window`` frames each (uint8 frames staged
    on the device before timing, after two warm-up windows). Returns (FPS,
    success rate, the last window's realized LM iterations).

    With ``diagnostics`` each window also returns its per-frame flow,
    confidence and depth maps, copied to the host every window inside the
    timed loop: what a viewer or logger adds to the stream
    (``infer_trajectory``'s diagnostics mode). ``fetch_diag=False`` makes
    the maps but skips the copy, which separates the device's cost from
    the host link's."""
    windows, masks = start_stream(est, t_window, n_windows + 2, seed0)
    for i in (-1, -2):                                     # warm-up
        res = est.track_window(windows[i][0], windows[i][1], masks,
                               diagnostics=diagnostics)
        poses = res[0]
    _ = float(poses.sum())
    if diagnostics:
        _ = {k: v.cpu() for k, v in res[2].items()}

    succs = []
    t0 = time.perf_counter()
    for i in range(n_windows):
        res = est.track_window(windows[i][0], windows[i][1], masks,
                               diagnostics=diagnostics)
        poses, succ = res[:2]
        succs.append(succ)  # kept on the device: a read a window would
        # serialize the launch queue
        if diagnostics and fetch_diag:
            # the viewer or logger takes the whole window's maps: one bulk
            # copy a window, which synchronizes as an interactive run does
            _ = {k: v.cpu() for k, v in res[2].items()}
    _ = float(poses.sum())        # waits for the last window
    dt = (time.perf_counter() - t0) / (n_windows * t_window)
    n_ok = int(torch.stack(succs).sum())
    # realized LM iterations of the last window, against the cap
    it = est.last_solver_iters.cpu().numpy().reshape(-1)
    iters = {"mean": round(float(it.mean()), 2), "max": int(it.max()),
             "min": int(it.min())}
    return 1.0 / dt, n_ok / (n_windows * t_window), iters


def measure_d2h_bandwidth(device, mb=24):
    """Device-to-host rate of one bulk copy (MB/s): a pageable ``.cpu()``
    of 24 MB of f16 over the card's host link. The diagnostics FPS is
    bound by this copy where the rate is small; printed beside it so the
    figure carries its cause. Two distinct tensors; the first copy warms
    the path and the second is timed."""
    xs = [torch.full((mb * (1 << 20) // 2,), float(i), dtype=torch.float16,
                     device=device) for i in range(2)]
    _ = xs[0].to("cpu", copy=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    _ = xs[1].to("cpu", copy=True)
    return mb / (time.perf_counter() - t0)


def _free(device):
    if device.type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None):
    from robust_pose_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="device selection (default cuda; without a card, "
                    "cpu must be named)")
    device = resolve_device(ap.parse_args(argv).device)

    d2h_mbps = measure_d2h_bandwidth(device)
    f2f_cfg = F2F_SLAM
    f2f = build_estimator(f2f_cfg, device=device)
    f2f_fps, f2f_ok, f2f_iters = bench_stream(f2f, t_window=F2F_WINDOW,
                                              n_windows=6)
    # viewer-attached mode: the same stream with the per-frame maps
    # (flow, confidences, depth) made and copied to the host every window
    f2f_diag = f2f_diag_nofetch = None
    if not os.environ.get("BENCH_SKIP_DIAG"):
        f2f_diag, _, _ = bench_stream(f2f, t_window=F2F_WINDOW, n_windows=4,
                                      diagnostics=True)
        f2f_diag_nofetch, _, _ = bench_stream(
            f2f, t_window=F2F_WINDOW, n_windows=4, diagnostics=True,
            fetch_diag=False)
    del f2f
    _free(device)

    # early-exit-off floor: every LM iteration runs to the cap of 20, a
    # bound that does not depend on the data being well conditioned
    f2f_floor = None
    if not os.environ.get("BENCH_SKIP_FLOOR"):
        floor_est = build_estimator(f2f_cfg, early_exit=False, device=device)
        f2f_floor, _, _ = bench_stream(floor_est, t_window=F2F_WINDOW,
                                       n_windows=4)
        del floor_est
        _free(device)

    f2m_cfg = f2m_slam()
    f2m = build_estimator(f2m_cfg, device=device)
    f2m_fps, f2m_ok, f2m_iters = bench_stream(f2m, t_window=F2M_WINDOW,
                                              n_windows=4, seed0=11)
    del f2m
    _free(device)

    # f2m floors: every LM iteration to the cap, 100 (the production cap)
    # and 20 (the f2f cap: how FPS scales with realized iterations)
    f2m_floor100 = f2m_floor20 = None
    if not os.environ.get("BENCH_SKIP_FLOOR"):
        fl100 = build_estimator(f2m_cfg, early_exit=False, device=device)
        f2m_floor100, _, _ = bench_stream(fl100, t_window=F2M_WINDOW,
                                          n_windows=2, seed0=11)
        del fl100
        _free(device)
        fl20 = build_estimator(dict(f2m_cfg, lbgfs_iters=20),
                               early_exit=False, device=device)
        f2m_floor20, _, _ = bench_stream(fl20, t_window=F2M_WINDOW,
                                         n_windows=2, seed0=11)
        del fl20
        _free(device)

    out = {
        "metric": "stereomis_tracking_fps_512x640_streaming",
        "value": round(f2f_fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(f2f_fps / 30.0, 3),
        "f2m_fps_iters100": round(f2m_fps, 3),
        "f2f_success_rate": round(f2f_ok, 3),
        "f2m_success_rate": round(f2m_ok, 3),
        # realized LM iterations (last window) against the caps 20 and 100
        "f2f_lm_iters": f2f_iters,
        "f2m_lm_iters": f2m_iters,
    }
    if f2f_floor is not None:
        out["f2f_fps_noearlyexit"] = round(f2f_floor, 3)
    if f2f_diag is not None:
        out["f2f_fps_diagnostics"] = round(f2f_diag, 3)
        # the maps are ~26 MB (f16) an 8-frame window: where d2h_MBps is
        # small the FPS above is bound by the copy; _nofetch is the same
        # stream without it
        out["f2f_fps_diagnostics_nofetch"] = round(f2f_diag_nofetch, 3)
        out["d2h_MBps"] = round(d2h_mbps, 1)
    if f2m_floor100 is not None:
        out["f2m_fps_noearlyexit"] = round(f2m_floor100, 3)
        out["f2m_fps_iters20_noearlyexit"] = round(f2m_floor20, 3)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
