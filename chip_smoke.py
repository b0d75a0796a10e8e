#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (robust_pose_tpu_torch) on one CUDA card.

    python3 chip_smoke.py           # every phase, then the result lines
    python3 chip_smoke.py kernels   # phases 1 and 2 only, phase 2 three times
                                    # over (its spread); no result line
    python3 chip_smoke.py small_train  # phase 1, then RAFT small's training
                                    # step 96 times a remat_policy from
                                    # 48 fresh trainers; no result line
    python3 chip_smoke.py cli       # phases 1, 4 and 14; no result line
    python3 chip_smoke.py train_cli # phases 1, 7 and 16; no result line
    python3 chip_smoke.py bench     # phases 1, 4, 9 and 21; no result line
    python3 chip_smoke.py ddp       # phases 1, 7 and 17; no result line
    python3 chip_smoke.py tools     # phases 1, 18, 19 and 20; no result line

Phases, each printing one JSON line:

1. device      -- the card (nvidia-smi name and power limit, printed raw on
                  their own line), torch/CUDA versions, kernel build time
                  (nvcc over robust_pose_tpu_torch/csrc/*.cu, one process per
                  source, in parallel).
2. kernels     -- each hand-written kernel against its plain PyTorch version
                  on the card at the shapes of its path (K1-K3: 512x640 f2f,
                  8-frame windows, K1 also at the f2m step's batch 1 and
                  its precompute's 8; K4-K5: the training step at batch 8;
                  K1, K4, K5 at noisy and at smooth centres; K6-K7: the f2m
                  step at batch 1 and its precompute at 8; K1, K4-K7 one
                  launch a 4-level lookup; K2 as two rows, its statistics
                  entry and the norm (statistics, normalize and ReLU in
                  one call; forward with and without the ReLU, backward),
                  at the three fnet shapes at B = 16 and 1; then RAFT
                  small's K1, K4, K5 at radius 3, K1 on C = 128 at B = 16
                  and 1, and K2 at its widths 32/64/96, as rows of their
                  own): max error vs the
                  stated tolerance; the time of one call three ways, ms (CUDA
                  events around back-to-back calls: the larger of the
                  host's and the card's share), device_ms (torch.profiler:
                  the summed duration of the kernels the call launches)
                  and host_us (host clock, no synchronisation); the plain
                  version's time, the time of one PyTorch library call
                  computing the same function where one exists, and the
                  least time the card could take (bytes over 3.35 TB/s or
                  operations over the peak rate of their type). K3's entry
                  also holds the LM solve kernel (one launch a solve): its
                  per-sample update bit for bit against the plain
                  version's arithmetic (lm_propose with solve6_lu,
                  se3.normalize/log) on 4,096 random proposals, then
                  solves from the identity at B = 8 (20 iterations), B = 1
                  (100) and B = 8 noise-free (100, every sample done early):
                  the same bits twice; iteration counts, done and failure
                  flags equal to the plain loop with K3 builds and the
                  kernel's LU on the card, pose within 1e-5 (and its bits);
                  within 1e-4 of the f64 plain loop; the loop of the CPU
                  path with K3 builds (cuBLAS's solve: the yardstick the
                  kernel replaces) timed beside it, its counts printed.
3. slice       -- the port's f2f path at 64x96 in f32 with TF32 off, once on
                  the card through the kernels and once on the CPU through
                  the plain versions (lookup "onthefly" on both: "auto"
                  takes "xla" on the CPU): poses, success flags and masks
                  must agree.
4. main        -- production f2f at full width (512x640, T = 8, 12 GRU
                  iterations, 20 LM iterations, confidence heads, 3 UNet
                  levels, bf16 mixed precision), random seeded weights, the
                  synthetic sequence of bench.py: first frame, 2 warm-up and
                  4 timed windows with every launch counter set to 0 just
                  before and read just after; then a bf16-vs-f32 pose check.
                  Every phase that drives a path holds the LM solve kernel
                  to exactly one launch a solve_pose call, and no K3 build
                  launched from Python.
5. profile     -- one more main-path window under torch.profiler (the
                  solve span: at most 40 launches a solve).
6. train_slice -- one PoseNetTrainer step with live RAFT gradients through
                  the lane-wise lookup at 64x96 in f32, on the card (kernels)
                  and on the CPU (plain versions), from the same weights and
                  batch: loss, every gradient and the updated parameters
                  must agree.
7. train       -- the training step at full width, configuration/train.yaml
                  (512x640, batch 8, 12 GRU iterations, 100 LM iterations,
                  weight heads, bf16): (a) RAFT frozen and cut off
                  (stop_flow_grad), (b) RAFT live through the lane-wise
                  lookup (freeze_flow_steps 0, remat). Each: 1 warm-up and 2
                  timed steps with the launch counters set to 0 just before
                  and read just after, then one step under torch.profiler
                  (train_profile) by stage of PoseNetTrainer.train_step.
8. f2m_slice   -- frame-to-model tracking at 64x96 in f32 on the card and on
                  the CPU, with lookup "onthefly" (K1) and "grouped" (K7):
                  first frame, one step, one 3-frame window; poses, flags,
                  surfel counts and rendered masks must agree. Then the
                  pool's overflow redo with average_pts and surfel upscale
                  2: a 4-frame window that outgrows its bucket, integer
                  outputs equal bit for bit.
9. f2m         -- production f2m at full width (configuration/
                  infer_scared.yaml: 100 LM iterations; the surfel pool
                  pre-sized to 4 frames as bench.py does), T = 8: first
                  frame, 2 warm-up and 4 timed windows with the launch
                  counters set to 0 just before and read just after; then
                  one timed window with lookup "grouped" (f2m_grouped), its
                  poses held against the default lookup's on the same
                  frames.
10. f2m_profile -- one more f2m window under torch.profiler, by span
                  (f2m_precompute, f2m_track.*, fuse_render).
11. small_slice -- RAFT's small variant (radius-3 window, 7 x 7) at 64x96
                  in f32, card against CPU: the f2f path of phase slice
                  (lookup "onthefly": K1 at radius 3), then the training
                  step of phase train_slice with RAFT small live through
                  K4/K5 at radius 3, remat_policy "dots" and dropout 0.1,
                  the CPU run replaying the card's dropout masks; the masks
                  themselves checked on the card (per-channel, 1/(1-p),
                  keep share).
12. small      -- RAFT small at full width: f2f windows as phase main
                  (success 1.0, bf16-vs-f32 gate) with its profile, then the
                  training step (train.yaml, small, batch 8, RAFT live
                  through K4/K5, remat, dropout 0.1) with remat_policy
                  "dots" and "nothing", each timed and profiled
                  (small_train, small_train_profile).
13. checkpoints -- save_checkpoint / load_checkpoint_any: an estimator from
                  the reloaded bundle gives the same poses, bit for bit;
                  save_train_state after step 1, load_train_state, step 2
                  against the uninterrupted step 2 (tolerances in the
                  phase).
14. cli        -- the trajectory-inference CLI (robust_pose_tpu_torch.
                  scripts.infer_trajectory): DevicePreproc on the card
                  against the CPU from 1024 x 1280 uint8 halves (maps:
                  masks and images bit for bit; pseudo shift: masks bit
                  for bit, images within 1e-3) and its device ms; then the
                  CLI's run at 512x640 from 2048 x 1280 frames in memory
                  with --window 8 --device-preproc, weights through
                  save_checkpoint / load_checkpoint_any: infer_f2f.yaml
                  (33 frames; K1, K2 and the LM solve counted a window)
                  and infer_scared.yaml (17 frames, its own pool size),
                  one warm-up pass and one timed, each with FPS (host
                  clock around the loop, ending in a synchronize) beside
                  phase main's, stage means, ATE/RPE and launches. Then
                  the scenario CLI's row loop (benchmark_scenarios.
                  run_rows) over two rows of 25 frames served from memory
                  through a StereoDataset subclass, each row's trajectory
                  file byte for byte that of a direct run over its range;
                  and the f2f run with --viewer 2d (a recording stand-in
                  for Viewer2D: every frame's maps finite, of their
                  shapes), its FPS beside the plain run's, and the device
                  time of one window's read-back of the maps.
15. ops_tail   -- the small ops off the main paths (ops/image, ops/
                  geometry.reproject, the three warps, ops/interpolation,
                  raft.lookup_corr_gather, PoseNet.run_flow) on the card
                  against the CPU at 64x96: nearest samples, medians (odd
                  and even windows) and validity bit for bit, the rest
                  within a stated tolerance.
16. train_cli  -- the training CLI (robust_pose_tpu_torch.scripts.
                  train_posenet.run) at full width on configuration/
                  train.yaml as read (freeze_flow_steps 10^18: lookup "xla",
                  remat, RAFT's gradients live and masked), then with
                  train.stop_flow_grad (K1): two training sequences and one
                  validation sequence of make_sequence frames in memory,
                  4 steps, validation every 2; the steps' launches, RAFT
                  unmoved, the best / last bundles reloaded bit for bit;
                  seconds a step by stage (data, step, log, val) beside
                  phase train's (a) and (b), peak memory; then
                  bench_train_step at batch 8 (remat and no-remat peaks,
                  as is and with --live-flow-grads).
17. ddp        -- data parallelism (robust_pose_tpu_torch.parallel.mesh)
                  at full width on configuration/train.yaml, global batch
                  8, phase train's weights and batch: (i) a world of 1
                  under NCCL through the mesh path, configurations (a) and
                  (b), a warm-up and 2 timed steps each, every step held
                  to the bare trainer's step from the same state
                  (gradients, Adam's moments and metrics rtol 2e-3, the
                  heads' BatchNorm statistics 1e-4, weights within Adam's
                  2 lr: the CPU test's bounds, widened by 3 times the bare
                  trainer's own run-to-run spread), seconds a step beside
                  phase train's, busy ms, idle share, the
                  train_step.allreduce span's host and device ms, peak
                  GiB, K1-K5 launches and collectives a step; (ii) a
                  world of 2 under gloo, both ranks on cuda:0 (spawned
                  with torch.multiprocessing, tcp://127.0.0.1), 4 rows a
                  rank: per rank the same figures (bf16), the ranks'
                  states bit for bit, and in f32 each step against the
                  bare trainer's on the global batch from the same state,
                  the spread widened by a replay on inputs perturbed by
                  1e-7 (in bf16 halving the batch moves the outputs by
                  2e-3 to 5e-2: printed); the same check must fail on (a)
                  with the heads' BatchNorm on each rank's own statistics;
                  (iii) the training CLI at world 2 (stop_flow_grad, f32,
                  grad_accum 1 and 2, 2 steps, one validation): rank 0
                  alone writes checkpoints, they load into a world-1
                  trainer; of each step the ranks' rows put together are
                  a world-1 CLI run's global batch, and metrics, weights
                  and validation loss are held to that run's; (iv)
                  bench_train_step at world 1 under NCCL beside phase
                  train_cli's.
18. parity     -- the golden-parity harness (robust_pose_tpu_torch.
                  scripts.verify_parity) against the reference network
                  (robust_pose_tpu_torch.reference, on the CPU in f32):
                  --selftest at 384x512, 5 frames, 4 GRU iterations, the
                  port on the card in f32 (K1, K2 and the LM solve kernel
                  each launched at least once a frame), recording the
                  reference's outputs; every row PASS, printed with its
                  value and tolerance; then --golden on that recording in
                  a second process: the same rows, bit for bit in value.
19. roofline   -- robust_pose_tpu_torch.scripts.roofline: the f2f (window
                  8), f2m (window 4, 100 LM iterations) and --train (batch
                  8, RAFT live through K4/K5) rows (counted
                  GFLOP and GB a frame, measured ms, bounds, MFU <= 100 %,
                  device-memory utilization, the binding resource), a
                  second counted run of each with the same FLOPs and rows
                  that sum to the totals, and each kernel wrapper's
                  registered FLOPs and bytes at phase 2's shapes equal to
                  the numbers its bound is computed from (the K2 norm: its
                  design's bytes, x read twice; its bound the floor).
20. tools      -- the profile tools on the card: profile_trace (f2f, 2
                  windows; its groups' ms within 1 % of the busy ms),
                  profile_stages, profile_f2m, profile_encoder (B = 1 and
                  16, K2 against the plain norm and conv only) and
                  ab_exact_render over 4 f2m frames.
21. bench      -- the port's streaming bench (robust_pose_tpu_torch.
                  scripts.bench.main, bench.py's defaults) in this process:
                  its one JSON line with bench.py's keys, FPS finite and
                  positive, success rates in [0, 1], LM iterations within
                  20 and 100, each window's launches (12 K1, 15 K2, 1 LM
                  solve an f2f window; an f2m window its precompute and
                  loops), printed beside phase main's and f2m's FPS.

Then one line {"kernels": [...]} and, last, {"ok": true, "device": ...}.
Every failed check raises: the script exits non-zero and prints no result.
TF32 stays off throughout (f32 products and convolutions in full f32).
"""
import json
import subprocess
import sys
import time

import numpy as np

from robust_pose_tpu_torch.utils import costs, profiling
from robust_pose_tpu_torch.utils.costs import window_taps
from robust_pose_tpu_torch.utils.profiling import device_events, profile_run

H, W = 512, 640
T_WINDOW = 8
N_TIMED = 4                   # timed windows of the main path
TRAIN_BATCH = 8               # configuration/train.yaml's batch_size
TRAIN_TIMED = 2               # timed training steps per configuration
FX = 500.0


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_time_ms(fn, reps=20, warmup=3):
    """Mean time of fn() on the card from CUDA events over ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_time_us(fn, reps=20, warmup=3):
    """What one fn() costs the host: time.perf_counter around ``reps`` calls
    with no synchronisation between them (the card drains the queue
    meanwhile), in microseconds a call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def device_time_ms(fn, reps=10, per_call=None):
    """What one fn() costs the card: the summed duration of every kernel,
    copy and memset it launches, from torch.profiler's device timeline,
    mean over ``reps`` calls; and how many of them one call launches
    (``per_call`` where the caller knows it)."""
    ev = device_events(fn, reps, per_call)
    return sum(e.time_range.elapsed_us() for e in ev) / reps / 1e3, len(ev) / reps


def device_times_ms(fns, reps=10):
    """The device ms of each of ``fns``, each launching one kernel, from
    one trace of ``reps`` rounds of them (exactly ``len(fns)`` events a
    round): fewer traces than one apiece."""
    ev = device_events(lambda: [f() for f in fns], reps, per_call=len(fns))
    return [sum(e.time_range.elapsed_us() for e in ev[i::len(fns)]) / reps / 1e3
            for i in range(len(fns))]


def measure(fn, reps=20, warmup=3, launches=None):
    """The three times of one fn() on CUDA tensors. ``ms``: CUDA events
    around ``reps`` back-to-back calls, so the larger of what the host and
    the card take a call; ``device_ms``: the card's share (profiler;
    ``launches`` is the device operations a call, where the caller knows
    it); ``host_us``: the host's share (no synchronisation). Where ms is
    near host_us / 1000 and far above device_ms, the host sets the time."""
    dev_ms, n = device_time_ms(fn, per_call=launches)
    return {"ms": cuda_time_ms(fn, reps, warmup), "device_ms": dev_ms,
            "host_us": host_time_us(fn, reps, warmup), "device_launches": n}


def make_sequence(n_frames, disparity=8, step=3, seed=0, h=None, w=None):
    """bench.py's synthetic scene: shifted crops of one box-blurred random
    texture, a horizontally translating stereo camera with constant
    disparity. Returns uint8 (T, 1, h, w, 3) left and right frames."""
    h, w = h or H, w or W
    rng = np.random.default_rng(seed)
    pad = disparity + step * n_frames + 8
    base = rng.uniform(0.0, 255.0, (h + 16, w + pad, 3)).astype(np.float32)
    k = 9
    c = np.cumsum(np.pad(base, ((k, k), (0, 0), (0, 0)), mode="edge"), axis=0)
    base = (c[2 * k:] - c[:-2 * k]) / (2 * k)
    c = np.cumsum(np.pad(base, ((0, 0), (k, k), (0, 0)), mode="edge"), axis=1)
    base = (c[:, 2 * k:] - c[:, :-2 * k]) / (2 * k)
    base = base[:h + 16]
    crop = lambda dx: base[8:8 + h, dx:dx + w]
    ls = np.stack([crop(step * i)[None] for i in range(n_frames)])
    rs = np.stack([crop(step * i + disparity)[None] for i in range(n_frames)])
    return ls.astype(np.uint8), rs.astype(np.uint8)


def tangent_distance(a, b, scale=1.0 / 250.0):
    """max |log(a^-1 b)| of (N, 7) poses, translations scaled to the
    solver's normalized depth units."""
    import torch

    from robust_pose_tpu_torch import se3

    a, b = (se3.scale(torch.as_tensor(x).double().reshape(-1, 7), scale)
            for x in (a, b))
    return float(se3.log(se3.mul(se3.inv(a), b)).abs().max())


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_device():
    import torch

    from robust_pose_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    libs = _build.build_all()
    require(set(libs) == {"corr_onthefly", "normal_eq", "corr_lanewise",
                          "corr_pixel", "instance_norm"}, f"built {set(libs)}")
    ptxas = {k: [l.strip() for l in v.splitlines() if "registers" in l]
             for k, v in _build.build_log.items()}
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "kernel_build_s": _build.build_seconds, "ptxas": ptxas})
    return smi


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def smooth_flow(b, xs, ys):
    """A flow field of the kind RAFT's GRU feeds a lookup: an affine term
    and a sinusoid of 1.5-2 px with periods of 40 queries and more, its
    phase shifted by the batch index. ``xs``, ``ys``: (H8, W8) query grid;
    returns (B, H8, W8, 2)."""
    import torch

    ph = torch.arange(b, device=xs.device, dtype=torch.float32)[:, None, None]
    h8, w8 = xs.shape
    tau = 2.0 * np.pi
    fx = (-1.5 + 0.01 * (xs - w8 / 2)
          + 2.0 * torch.sin(tau * (xs / 48.0 + ys / 64.0) + ph))
    fy = (0.4 + 0.008 * (ys - h8 / 2)
          + 1.5 * torch.cos(tau * (xs / 64.0 - ys / 40.0) + 0.5 * ph))
    return torch.stack([fx, fy], -1)


def corr_inputs(dev, b, centres, dtype, h8=H // 8, w8=W // 8, seed=1, c=256):
    """K1 inputs: f1 (B, H8, W8, C) and the 4 levels of f2 (pooled in f32,
    then cast to ``dtype``, as RAFT does) of random features, and centres
    (B, H8, W8, 2): ``noisy``, the identity plus 4 px of noise drawn a query
    (the input on record since K1 was first ported; no path feeds it);
    ``smooth``, the identity plus ``smooth_flow``, what RAFT's GRU feeds
    the lookup; both with 200 queries whose windows lie off the map;
    ``ragged``, 2.5 px of noise with queries far off, huge, infinite and
    NaN."""
    import torch

    from robust_pose_tpu_torch.ops import corr_onthefly as K1

    g = torch.Generator(device=dev).manual_seed(seed)
    f1 = torch.randn(b, h8 * w8, c, generator=g, device=dev).to(dtype)
    f2 = torch.randn(b, h8, w8, c, generator=g, device=dev)
    levels = [l.to(dtype).contiguous() for l in K1.pool_fmap_pyramid(f2)]
    ys, xs = torch.meshgrid(torch.arange(h8, device=dev, dtype=torch.float32),
                            torch.arange(w8, device=dev, dtype=torch.float32),
                            indexing="ij")
    base = torch.stack([xs, ys], -1).reshape(1, -1, 2)
    if centres == "smooth":
        coords = base + smooth_flow(b, xs, ys).reshape(b, -1, 2)
    else:
        sd = 4.0 if centres == "noisy" else 2.5
        coords = base + sd * torch.randn(b, h8 * w8, 2, generator=g, device=dev)
    if centres == "ragged":
        coords[:, :8] -= 40.0
        coords[:, 8:12] = coords[:, 8:12] * 3.0 - 20.0
        coords[:, 12] = float("nan")
        coords[:, 13, 0] = float("nan")
        coords[:, 14, 1] = float("nan")
        coords[:, 15] = 1e30
        coords[:, 16] = float("-inf")
        coords[:, 17, 0] = float("inf")
    else:
        coords[:, :200] -= 40.0                   # windows off the map
    return (f1.reshape(b, h8, w8, c), levels,
            coords.reshape(b, h8, w8, 2).contiguous())


def corr_entries(f1, levels, coords, radius=4):
    """The calls of one K1 lookup on these inputs, each returning per-level
    (B, D*D, N) f32: the kernel through ``onthefly_lookup`` (RAFT's entry:
    one launch a pyramid, or one a level in an earlier tree of the
    package), the plain version, and ``level(l)``, level l alone through the
    kernel with the queries in their 2-D tiles where the package has a
    pyramid entry."""
    from robust_pose_tpu_torch.ops import corr_onthefly as K1

    b, h8, w8, c = f1.shape
    f1f, cs = f1.reshape(b, h8 * w8, c), coords.reshape(b, h8 * w8, 2)
    kernel = lambda: K1.onthefly_lookup(f1, levels, coords, radius)
    plain = lambda: [K1.corr_lookup_level_plain(f1f, v, cs, radius, 2.0 ** l)
                     for l, v in enumerate(levels)]
    if hasattr(K1, "onthefly_lookup_pyramid"):
        level = lambda l: K1.onthefly_lookup_pyramid(f1, [levels[l]], coords,
                                                     radius, 2.0 ** l)
    else:
        level = lambda l: K1.corr_lookup_level(f1f, levels[l], cs, radius,
                                               2.0 ** l)
    return kernel, plain, level


def corr_check(f1, levels, coords, tol, what, radius=4):
    """K1 against its plain version (NaNs at the same places), the same
    bits from two calls, and one buffer for the levels where the package
    has a pyramid entry; returns the largest error."""
    from robust_pose_tpu_torch.ops import corr_onthefly as K1

    kernel, plain, _ = corr_entries(f1, levels, coords, radius)
    got = kernel()
    err = lookup_err(got, plain(), f"corr {what}")
    require(err <= tol, f"corr {what}: max |err| {err} > {tol}")
    require(same_bits(got, kernel()), f"corr {what}: two runs differ")
    if hasattr(K1, "onthefly_lookup_pyramid"):
        require(len({o.untyped_storage().data_ptr() for o in got}) == 1,
                f"corr {what}: the levels are not views of one buffer")
    return err


def corr_bound(f1, levels, coords, radius=4):
    """Bytes: f1, the levels and the centres read once, the outputs written
    once; operations: one C-long multiply-add per in-level window pixel
    (the (2r+2)^2 a radius-r bilinear window touches), at the peak rate of
    the inputs' type. Returns (bound ms, what bounds it, bytes, ops)."""
    b, h8, w8, c = f1.shape
    ops, nbytes, dt = costs.corr_window(f1.reshape(b, h8 * w8, c), levels,
                                        coords, radius)
    return (*costs.bound(nbytes, {dt: ops}), nbytes, ops)


K1_CASES = (("noisy", 2 * T_WINDOW, "noisy"), ("smooth", 2 * T_WINDOW, "smooth"),
            ("smooth_b1", 1, "smooth"), ("smooth_b8", T_WINDOW, "smooth"))


def kernel_corr(dev, radius=4, c=256, cases=K1_CASES):
    """K1 at the main path's shapes, 64 x 80 queries, bf16, all 4 levels:
    radius 4 and C = 256 (RAFT large) at B = 16 (an f2f window, 2T) at
    ``noisy`` centres (the row on record) and at ``smooth`` ones, B = 1
    (the f2m per-frame step) and B = 8 (the f2m precompute) at ``smooth``;
    radius 3 and C = 128 (RAFT small) at B = 16 and B = 1. Each against the
    plain version (bf16 products are exact in f32: only the order of the f32
    sums differs, tol 1e-4) and timed with the device time of each level,
    beside the whole-slab product that the Pallas kernel computes
    (``torch.bmm`` of level-0 f2 with f1^T; the port never calls it). Then
    the f32 instantiation (B = 2, tol 1e-5) timed apart, a ragged case
    (B = 3, 15 x 19: N = 285, f32 and bf16, far-off, huge, infinite and NaN
    centres) and the one-level entry at level 2."""
    import torch

    from robust_pose_tpu_torch.ops import corr_onthefly as K1

    saved = K1.launches
    one_launch = hasattr(K1, "onthefly_lookup_pyramid")
    dd = (2 * radius + 1) ** 2
    rows = {}
    worst = 0.0
    for what, b, centres in cases:
        f1, levels, coords = corr_inputs(dev, b, centres, torch.bfloat16, c=c)
        tol = 1e-4    # f32 sums of C exact bf16 products, in other orders
        err = corr_check(f1, levels, coords, tol, what, radius)
        worst = max(worst, err)
        kernel, plain, level = corr_entries(f1, levels, coords, radius)
        t = measure(kernel, launches=1 if one_launch else None)
        if one_launch:
            require(t["device_launches"] == 1,
                    f"corr {what}: {t['device_launches']} device launches a call")
        bound, by, nbytes, ops = corr_bound(f1, levels, coords, radius)
        f1f = f1.reshape(b, -1, c)
        f2f = levels[0].reshape(b, -1, c)
        slab = lambda: torch.bmm(f2f, f1f.transpose(1, 2))
        rows[what] = {
            "batch": b, "centres": centres, **t,
            "plain_ms": cuda_time_ms(plain, reps=3, warmup=1),
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "level_device_ms": device_times_ms(
                [lambda l=l: level(l) for l in range(len(levels))]),
            "slab_matmul_ms": cuda_time_ms(slab, reps=10),
            "max_abs_err": err, "tol": tol, "bytes": nbytes, "ops": ops}
        del f1, levels, coords, kernel, plain, level, f1f, f2f, slab
        torch.cuda.empty_cache()
    # f32: exact FMAs on the CUDA cores (the card-vs-CPU phases' dtype)
    f1, levels, coords = corr_inputs(dev, 2, "smooth", torch.float32, c=c)
    err32 = corr_check(f1, levels, coords, 1e-5, "f32", radius)
    kernel, plain, _ = corr_entries(f1, levels, coords, radius)
    bound, by, nbytes, ops = corr_bound(f1, levels, coords, radius)
    f32_row = {"batch": 2, "centres": "smooth", **measure(kernel),
               "plain_ms": cuda_time_ms(plain, reps=3, warmup=1),
               "bound_ms": bound, "bound_by": by, "max_abs_err": err32,
               "tol": 1e-5}
    # the one-level entry at level 2 (its queries in one row of tiles)
    f1, levels, coords = corr_inputs(dev, 2 * T_WINDOW, "smooth", torch.bfloat16,
                                     c=c)
    b = f1.shape[0]
    f1f, cs = f1.reshape(b, -1, c), coords.reshape(b, -1, 2)
    lvl2 = lookup_err(
        [K1.corr_lookup_level(f1f, levels[2], cs, radius, 4.0)],
        [K1.corr_lookup_level_plain(f1f, levels[2], cs, radius, 4.0)],
        "corr level 2")
    require(lvl2 <= 1e-4, f"corr level 2: max |err| {lvl2} > 1e-4")
    ragged = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-4)):
        f1, levels, coords = corr_inputs(dev, 3, "ragged", dtype, 15, 19, seed=8,
                                         c=c)
        ref = corr_entries(f1, levels, coords, radius)[1]()
        require(all(bool(torch.isnan(r).any()) for r in ref)
                and tuple(ref[-1].shape) == (3, dd, 285),
                "corr ragged: the NaN centres were lost")
        ragged[str(dtype).split(".")[-1]] = corr_check(
            f1, levels, coords, tol, f"ragged {dtype}", radius)
    del f1, levels, coords, f1f, cs, kernel, plain
    torch.cuda.empty_cache()
    K1.launches = saved
    worst = max(worst, err32, lvl2, *ragged.values())
    n_launch = "1 launch" if one_launch else "4 launches"
    return {"name": "corr_window_lookup" + ("" if radius == 4 else f"_r{radius}"),
            "route": "cuda",
            "source": "robust_pose_tpu_torch/csrc/corr_onthefly.cu",
            "replaces": "robust_pose_tpu/ops/pallas_corr_onthefly.py:64",
            "max_abs_err": worst, "tol": {"bf16": 1e-4, "f32": 1e-5},
            **{k: rows["noisy"][k] for k in (
                "ms", "device_ms", "host_us", "device_launches", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "bytes", "ops")},
            "unit": f"one 4-level lookup at B = 16, radius {radius}, C = {c} "
                    f"({n_launch})",
            "per_input": rows, "f32": f32_row, "level2_err": lvl2,
            "err_ragged": ragged}


K2_BATCHES = (2 * T_WINDOW, 1)   # an f2f window's fnet batch, the f2m step's
# norms of one fnet pass at each of its three scales (1/2, 1/4, 1/8): the
# stem's and the residual blocks' norm1 / norm2 take the ReLU (5, 4, 4),
# the two downsample norms do not (0, 1, 1)
K2_RELU_NORMS = (5, 4, 4)
K2_PLAIN_NORMS = (0, 1, 1)


def bf16_ulp_err(got, ref):
    """max |got - ref| in units of one bf16 ulp of |ref| (8 significant
    bits), |ref| taken at least 2^-12: below that the f32 rounding of the
    statistics (~1e-7 of |mu| rstd), not the bf16 cast, separates two
    correct results. The fused norm's bound is 1: the two versions sum the
    statistics in other orders, so a value on a rounding boundary may round
    the other way."""
    import torch

    ref = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -12))) - 7)
    return float(((got.float() - ref).abs() / ulp).max())


def k2_stats_err(got, ref, hw):
    """Relative error of the statistics: f32 sums of hw terms in other
    orders (the sum's against its magnitude plus hw 1e-2)."""
    (s_k, ss_k), (s_p, ss_p) = got, ref
    return max(float(((s_k - s_p).abs() / (s_p.abs() + hw * 1e-2)).max()),
               float(((ss_k - ss_p).abs() / ss_p.abs()).max()))


K2_KINK = 1e-5    # |y| under which the ReLU's side is the sums' rounding


def k2_backward_err(dev, shape, relu, g):
    """The norm's gradient on an f32 input (the kernel forward, the backward
    through the statistics kernel) against the plain composition's
    autograd gradient: max |err| over max |ref|, bound 1e-4 (rtol 1e-4:
    the statistics summed in other orders); and the f32 forward's max
    |err| (bound 1e-5 on unit-variance outputs). With the ReLU, elements
    whose plain output lies within K2_KINK of 0 are left out of the
    gradient's comparison (a few in 10^7 of these inputs): the two
    versions' sums may put them on either side of the kink, which moves
    that element's gradient by O(1) and every other one of its (sample,
    channel) by ~1 / (H W), well inside the bound."""
    import torch

    from robust_pose_tpu_torch.ops import instance_norm as K2

    x = (torch.randn(shape, generator=g, device=dev) * 2.0 + 0.5).requires_grad_()
    ct = torch.randn(shape, generator=g, device=dev)
    y = K2.instance_norm(x, relu=relu)
    y.backward(ct)
    xr = x.detach().clone().requires_grad_()
    yr = K2.instance_norm_plain(xr, relu=relu)
    yr.backward(ct)
    fwd = float((y - yr).detach().abs().max())
    keep = yr.detach().abs() > K2_KINK if relu else torch.ones_like(x, dtype=torch.bool)
    bwd = float(torch.where(keep, x.grad - xr.grad, 0.0).abs().max()
                / xr.grad.abs().max())
    require(fwd <= 1e-5 and bwd <= 1e-4,
            f"instance_norm f32 {shape} relu={relu}: forward {fwd}, backward "
            f"{bwd} of max |grad|")
    return fwd, bwd


def kernel_instance_norm(dev, widths=(64, 96, 128)):
    """K2 (csrc/instance_norm.cu) at the three fnet shapes in bf16, at an f2f
    window's batch of 16 and the f2m step's batch of 1; (C1, C2, C3) =
    (64, 96, 128) in RAFT large, (32, 64, 96) in RAFT small (its fnet also
    has 5 norms at each of the three scales). Two rows: the statistics
    entry (``instance_norm_stats``, K2's own function: the training
    backward's 15 calls a fnet pass) against its plain version at rel 1e-5,
    and the norm (``instance_norm``, one ``instance_norm_fwd`` call: the
    statistics, then y = [relu]((x - mu) rstd)), with and without the ReLU,
    against ``instance_norm_plain`` to one bf16 ulp (``bf16_ulp_err``),
    its mu / rstd against the plain ones (rel 1e-5), the same bits twice,
    and its backward on an f32 input against the plain composition's
    autograd gradient (rtol 1e-4); then both at widths the 16-byte loads
    do not divide (one element a thread). Times of one fnet pass: the statistics
    5 x (t(256x320xC1) + t(128x160xC2) + t(64x80xC3)); the norm with each
    scale's norms with and without the ReLU (K2_RELU_NORMS,
    K2_PLAIN_NORMS). Yardsticks: ``torch.sum`` of x and x^2 in f32 for the
    statistics, ``F.instance_norm`` of the NCHW channels_last view (then
    ``F.relu``) for the norm."""
    import torch
    import torch.nn.functional as F

    from robust_pose_tpu_torch.models.raft import nchw
    from robust_pose_tpu_torch.ops import instance_norm as K2

    saved = (K2.launches, K2.stats_launches)
    g = torch.Generator(device=dev).manual_seed(2)
    shapes = [(H // 2, W // 2, widths[0]), (H // 4, W // 4, widths[1]),
              (H // 8, W // 8, widths[2])]
    keys = ("ms", "device_ms", "host_us", "device_launches", "plain_ms",
            "library_ms", "bytes", "ops", "design_bytes")
    per_batch = {}
    errs = {"stats_rel": 0.0, "stats_abs": 0.0, "norm_ulp": 0.0, "norm_abs": 0.0,
            "moments_rel": 0.0, "f32_forward": 0.0, "backward_rel": 0.0}
    for b in K2_BATCHES:
        tot = {"stats": dict.fromkeys(keys, 0.0), "norm": dict.fromkeys(keys, 0.0)}
        per = []
        for (h, w, c), n_relu, n_plain in zip(shapes, K2_RELU_NORMS, K2_PLAIN_NORMS):
            x = (torch.randn(b, h, w, c, generator=g, device=dev) * 2.0 + 0.5
                 ).bfloat16()
            got = K2.instance_norm_stats(x)
            ref = K2.instance_norm_stats_plain(x)
            err = k2_stats_err(got, ref, h * w)
            require(err <= 1e-5, f"instance_norm_stats {b}x{h}x{w}x{c} rel err {err}")
            require(same_bits(got, K2.instance_norm_stats(x)),
                    f"instance_norm_stats {b}x{h}x{w}x{c}: two runs differ")
            errs["stats_rel"] = max(errs["stats_rel"], err)
            errs["stats_abs"] = max(errs["stats_abs"], *(
                float((k - p).abs().max()) for k, p in zip(got, ref)))
            t = measure(lambda: K2.instance_norm_stats(x), launches=2)
            ops, nbytes, _ = costs.instance_norm_stats(x)
            row_s = {**t, "plain_ms": cuda_time_ms(
                lambda: K2.instance_norm_stats_plain(x), reps=5),
                "library_ms": cuda_time_ms(
                    lambda: (torch.sum(x, (1, 2), dtype=torch.float32),
                             torch.sum(x * x, (1, 2), dtype=torch.float32))),
                "bytes": nbytes, "ops": ops, "design_bytes": nbytes, "rel_err": err}
            for k in keys:
                tot["stats"][k] += 5 * row_s[k]
            # the plain moments from the plain sums (ops/instance_norm's formula)
            mu_p = ref[0] / (h * w)
            rstd_p = torch.rsqrt(torch.clamp(ref[1] / (h * w) - mu_p * mu_p, min=0.0)
                                 + K2.EPS)
            rows_n = {}
            for relu, count in ((True, n_relu), (False, n_plain)):
                y, mu, rstd = K2.instance_norm_fwd(x, relu=relu)
                y_p = K2.instance_norm_plain(x, relu=relu)
                ulp = bf16_ulp_err(y, y_p)
                mom = max(float(((mu - mu_p).abs() / (mu_p.abs() + 1e-2)).max()),
                          float(((rstd - rstd_p).abs() / rstd_p).max()))
                require(ulp <= 1.0 and mom <= 1e-5,
                        f"instance_norm {b}x{h}x{w}x{c} relu={relu}: {ulp} bf16 "
                        f"ulp, moments rel err {mom}")
                require(torch.equal(y.view(torch.int16),
                                    K2.instance_norm(x, relu=relu).view(torch.int16)),
                        f"instance_norm {b}x{h}x{w}x{c}: two runs differ")
                errs["norm_ulp"] = max(errs["norm_ulp"], ulp)
                errs["norm_abs"] = max(errs["norm_abs"],
                                       float((y.float() - y_p.float()).abs().max()))
                errs["moments_rel"] = max(errs["moments_rel"], mom)
                fwd, bwd = k2_backward_err(dev, (b, h, w, c), relu, g)
                errs["f32_forward"] = max(errs["f32_forward"], fwd)
                errs["backward_rel"] = max(errs["backward_rel"], bwd)
                del y, mu, rstd, y_p
                xn = nchw(x)
                lib = ((lambda: F.relu(F.instance_norm(xn))) if relu
                       else (lambda: F.instance_norm(xn)))
                t = measure(lambda: K2.instance_norm(x, relu=relu), launches=3)
                ops, nbytes, _ = costs.instance_norm(x, x_reads=1)
                rows_n["relu" if relu else "no_relu"] = r = {
                    **t, "plain_ms": cuda_time_ms(
                        lambda: K2.instance_norm_plain(x, relu=relu), reps=5),
                    "library_ms": cuda_time_ms(lib), "bytes": nbytes, "ops": ops,
                    "design_bytes": costs.instance_norm(x)[1], "ulp_err": ulp}
                for k in keys:
                    tot["norm"][k] += count * r[k]
            per.append({"shape": [b, h, w, c], "stats": row_s, "norm": rows_n})
            del x, got, ref, mu_p, rstd_p
            torch.cuda.empty_cache()
        for k in ("stats", "norm"):
            tot[k]["bound_ms"], tot[k]["bound_by"] = costs.bound(
                tot[k]["bytes"], {"f32": tot[k]["ops"]})
            tot[k]["design_bound_ms"] = costs.bound(
                tot[k]["design_bytes"], {"f32": tot[k]["ops"]})[0]
        per_batch[str(b)] = {"stats": tot["stats"], "norm": tot["norm"],
                             "per_shape": per}
    # the one-element-a-thread path: C not a multiple of the 16-byte vector
    # (36 bf16, 18 f32), H W = 391 rows
    for dtype, c in ((torch.bfloat16, 36), (torch.float32, 18)):
        x = (torch.randn(3, 17, 23, c, generator=g, device=dev) * 2.0 + 0.5
             ).to(dtype)
        err = k2_stats_err(K2.instance_norm_stats(x),
                           K2.instance_norm_stats_plain(x), 17 * 23)
        ulp = bf16_ulp_err(K2.instance_norm(x, relu=True),
                           K2.instance_norm_plain(x, relu=True))
        require(err <= 1e-5 and ulp <= 1.0,
                f"instance_norm {tuple(x.shape)} {dtype}: statistics rel err "
                f"{err}, norm {ulp} bf16 ulp")
        errs["stats_rel"] = max(errs["stats_rel"], err)
        errs["norm_ulp"] = max(errs["norm_ulp"], ulp)
    K2.launches, K2.stats_launches = saved
    sfx = "" if widths[0] == 64 else "_small"
    head = per_batch[str(K2_BATCHES[0])]
    common = {"route": "cuda", "source": "robust_pose_tpu_torch/csrc/instance_norm.cu",
              "replaces": "robust_pose_tpu/ops/pallas_instance_norm.py:27"}
    top = ("ms", "device_ms", "host_us", "device_launches", "plain_ms",
           "bound_ms", "bound_by", "library_ms", "design_bound_ms", "bytes", "ops")
    return [
        {"name": "instance_norm_stats" + sfx, **common,
         "max_abs_err": errs["stats_abs"], "tol": "rel 1e-5",
         **{k: head["stats"][k] for k in top},
         "unit": "one fnet pass at B = 16: 15 statistics calls (30 kernels)",
         "per_batch": {k: {"stats": v["stats"], "per_shape": [
             {"shape": p["shape"], **p["stats"]} for p in v["per_shape"]]}
             for k, v in per_batch.items()}, "errors": errs},
        {"name": "instance_norm" + sfx, **common,
         "max_abs_err": errs["norm_abs"],
         "tol": {"bf16": "1 ulp of max(|y|, 2^-12)", "moments": "rel 1e-5",
                 "f32_forward": 1e-5, "backward": "rtol 1e-4"},
         **{k: head["norm"][k] for k in top},
         "unit": "one fnet pass at B = 16: 15 norms (13 with the ReLU), "
                 "15 calls (45 kernels)",
         "per_batch": {k: {"norm": v["norm"], "per_shape": [
             {"shape": p["shape"], **p["norm"]} for p in v["per_shape"]]}
             for k, v in per_batch.items()}, "errors": errs}]


def solver_inputs(dev, b=T_WINDOW, noise=True, seed=3):
    """Seeded LM problems at 512x640: a random depth map's cloud, the flow
    and 3D targets of a random small pose (with 0.3 px of flow noise and
    0.01 of point noise unless ``noise`` is False), random weights and
    masks. Returns (planes, kvec, loss_weight) of ``pack_planes`` and the
    generator, for more draws."""
    import torch

    from robust_pose_tpu_torch import se3
    from robust_pose_tpu_torch.ops import normal_eq as K3
    from robust_pose_tpu_torch.ops.geometry import create_img_coords, depth_to_pcl
    from robust_pose_tpu_torch.solver.objectives import PoseProblemInputs

    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.rand(*s, generator=g, device=dev)
    K = torch.tensor([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]],
                     device=dev).expand(b, 3, 3)
    coords = create_img_coords(H, W, device=dev)
    pcl1 = depth_to_pcl(0.2 + 0.8 * r(b, H, W, 1), K, coords)
    pose_gt = se3.exp(0.02 * torch.randn(b, 6, generator=g, device=dev))
    pp = se3.act(pose_gt[:, None], pcl1.reshape(b, -1, 3))
    proj = pp @ K.transpose(1, 2)
    flow = proj[..., :2] / proj[..., 2:] - coords[None, :, :2]
    sf, sp = (0.3, 0.01) if noise else (0.0, 0.0)
    xs = PoseProblemInputs(
        flow=(flow + sf * torch.randn(flow.shape, generator=g, device=dev)
              ).reshape(b, H, W, 2),
        pcl1=pcl1, pcl2=(pp + sp * torch.randn(pp.shape, generator=g,
                                               device=dev)).reshape(b, H, W, 3),
        weights1=r(b, H, W, 1), weights2=r(b, H, W, 1),
        mask1=r(b, H, W, 1) > 0.1, mask2=r(b, H, W, 1) > 0.2, intrinsics=K,
        loss_weight=torch.tensor([[0.5, 1.5]], device=dev).expand(b, 2))
    planes, kvec = K3.pack_planes(xs, H, W)
    return planes, kvec, xs.loss_weight.contiguous(), g


def kernel_normal_eq(dev):
    """K3 at B = T = 8, 512x640, f32, at a random pose with random weights
    and masks; also checks that two runs give the same bits."""
    import torch

    from robust_pose_tpu_torch import se3
    from robust_pose_tpu_torch.ops import normal_eq as K3

    b = T_WINDOW
    planes, kvec, lw, g = solver_inputs(dev, b)
    pose = se3.exp(0.01 * torch.randn(b, 6, generator=g, device=dev))
    Hk, gk, ck = K3.normal_equations(pose, planes, kvec, lw, H, W)
    Hk2, gk2, ck2 = K3.normal_equations(pose, planes, kvec, lw, H, W)
    require(torch.equal(Hk, Hk2) and torch.equal(gk, gk2) and torch.equal(ck, ck2),
            "normal_eq is not bitwise reproducible")
    Hp, gp, cp = K3.normal_equations_plain(pose, planes, kvec, lw, H, W)
    # the f32 sums run over 2.6M pixels: both the kernel and the plain
    # version (cuBLAS over the materialized Jacobians) are held against an
    # f64 evaluation of the same plain version, the kernel at rel 1e-4 of
    # max |H|, and against each other at twice the plain version's own error
    Hd, gd, cd = K3.normal_equations_plain(pose.double(), planes.double(),
                                           kvec.double(), lw.double(), H, W)
    scale_h = float(Hd.abs().max())
    scale_g = float(gd.abs().max())

    def rel(Hx, gx, cx):
        return max(float((Hx - Hd).abs().max()) / scale_h,
                   float((gx - gd).abs().max()) / scale_g,
                   float(((cx - cd).abs() / cd.abs()).max()))

    err_k64 = rel(Hk.double(), gk.double(), ck.double())
    err_p64 = rel(Hp.double(), gp.double(), cp.double())
    err_kp = max(float((Hk - Hp).abs().max()) / scale_h,
                 float((gk - gp).abs().max()) / scale_g)
    tol_kp = 1e-4 + 2.0 * err_p64
    require(err_k64 <= 1e-4, f"normal_eq vs f64: rel err {err_k64} > 1e-4")
    require(err_kp <= tol_kp, f"normal_eq vs plain: rel err {err_kp} > {tol_kp}")
    saved = K3.launches
    t = measure(lambda: K3.normal_equations(pose, planes, kvec, lw, H, W))
    K3.launches = saved
    plain_ms = cuda_time_ms(
        lambda: K3.normal_equations_plain(pose, planes, kvec, lw, H, W), reps=5)
    ops, nbytes, _ = costs.normal_equations(b, H, W)
    bound, by = costs.bound(nbytes, {"f32": ops})
    return {"name": "normal_eq", "route": "cuda",
            "source": "robust_pose_tpu_torch/csrc/normal_eq.cu",
            "replaces": "robust_pose_tpu/ops/pallas_normal_eq.py:61",
            "max_abs_err": float((Hk - Hp).abs().max()),
            "rel_err": {"kernel_vs_f64": err_k64, "plain_vs_f64": err_p64,
                        "kernel_vs_plain": err_kp},
            "tol": {"kernel_vs_f64": 1e-4, "kernel_vs_plain": tol_kp},
            **t, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "unit": "one H/g/cost build (2 kernels); "
            "launches on the path: LM solves (lm_solve, every build inside)",
            "bytes": nbytes, "ops": ops}


def propose_inputs(dev, n=4096, seed=13):
    """LM proposals to hold the solve kernel's update to its plain version:
    SPD H over six orders of magnitude, steps from 1e-7 to 2 (both Taylor
    branches of exp and large angles), damping from 1e-9 to 1e6, random
    poses; the last rows a zero system (H = g = 0) and a NaN in H."""
    import torch

    from robust_pose_tpu_torch import se3

    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    J = rn(n, 12, 6)
    Hm = (J.transpose(1, 2) @ J) * 10.0 ** (12 * torch.rand(n, 1, 1, generator=g,
                                                             device=dev) - 6)
    step = rn(n, 6) * 10.0 ** (-7 + 7.3 * torch.rand(n, 1, generator=g, device=dev))
    gv = -(Hm @ step[..., None])[..., 0]
    lam = 10.0 ** (15 * torch.rand(n, generator=g, device=dev) - 9)
    pose = se3.exp(0.3 * rn(n, 6))
    Hm[-2], gv[-2] = 0.0, 0.0
    Hm[-1, 2, 3] = float("nan")
    return Hm.contiguous(), gv.contiguous(), lam.contiguous(), pose.contiguous()


def bits_equal(a, b):
    """Bit for bit, NaNs included."""
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def solve_case(dev, name, planes, kvec, lw, cfg):
    """One LM solve case for kernel_lm_solve: the kernel twice (the same
    bits), against the plain loop with K3 builds and the kernel's LU on the
    card (counts, flags and pose bits), the plain loop of the port's
    CPU path with K3 builds (cuBLAS's solve: the yardstick this kernel
    replaces, counts printed) and the f64 plain loop; times and bound."""
    import torch

    from robust_pose_tpu_torch.ops import normal_eq as K3

    b = planes.shape[0]
    saved = (K3.launches, K3.solve_launches)
    kern = lambda: K3.lm_solve(planes, kvec, lw, H, W, cfg, flags=True)
    k1, k2 = kern(), kern()
    require(all(bits_equal(x.float(), y.float()) for x, y in zip(k1, k2)),
            f"lm_solve {name}: two runs differ")
    loop = lambda solve: K3.lm_solve_plain(planes, kvec, lw, H, W, cfg,
                                           build=K3.normal_equations,
                                           solve=solve, flags=True)
    yl, ye = loop(K3.solve6_lu), loop(K3.solve6)
    yd = K3.lm_solve_plain(planes.double(), kvec.double(), lw.double(), H, W,
                           cfg, flags=True)
    dist = lambda a, c: tangent_distance(a.cpu(), c.cpu(), scale=1.0)
    pose, niter, done, failed = (x.cpu() for x in k1)
    res = {"b": b, "iters": cfg.iters, "niter": niter.tolist(),
           "done": done.tolist(), "failed": failed.tolist(),
           "niter_k3_loop_lu": yl[1].tolist(),
           "niter_k3_loop_solve_ex": ye[1].tolist(), "niter_f64": yd[1].tolist(),
           "pose_bits_equal_k3_loop_lu": bits_equal(k1[0], yl[0].contiguous()),
           "pose_dist_k3_loop_lu": dist(k1[0], yl[0]),
           "pose_dist_k3_loop_solve_ex": dist(k1[0], ye[0]),
           "pose_dist_f64": dist(k1[0], yd[0]),
           "samples_niter_differ_solve_ex": int((ye[1].cpu() != niter).sum())}
    require(torch.equal(niter, yl[1].cpu()) and torch.equal(done, yl[2].cpu())
            and torch.equal(failed, yl[3].cpu()),
            f"lm_solve {name}: counts or flags differ from the K3 loop {res}")
    require(res["pose_dist_k3_loop_lu"] <= 1e-5, f"lm_solve {name}: {res}")
    require(res["pose_dist_f64"] <= 1e-4, f"lm_solve {name}: vs f64 {res}")
    run = lambda: K3.lm_solve(planes, kvec, lw, H, W, cfg)
    t = measure(run, reps=10, warmup=2)
    builds = int((1 + niter).sum())
    ops, nbytes, _ = costs.lm_solve(niter, H, W)
    bound, by = costs.bound(nbytes, {"f32": ops})
    res.update(t)
    ident = torch.zeros((b, 7), device=dev)
    ident[:, 6] = 1.0
    build_ms, _ = device_time_ms(
        lambda: K3.normal_equations(ident, planes, kvec, lw, H, W))
    res.update({
        "builds": builds, "rounds": 1 + int(niter.max()),
        # one K3 build of all B samples alone (2 kernels): the rest of a
        # round is barriers and the per-sample update
        "build_device_ms": build_ms,
        "ms_per_iteration": t["device_ms"] / (1 + int(niter.max())),
        "bound_ms": bound, "bound_by": by,
        # the planes read from device memory once, every later build from
        # on-chip memory (possible at B = 1: 13.1 MB)
        "bound_ms_planes_once": costs.bound(b * 10 * H * W * 4, {"f32": ops})[0],
        "k3_loop_ms": cuda_time_ms(lambda: loop(K3.solve6), reps=3, warmup=1),
        "k3_loop_device_ms_launches": device_time_ms(lambda: loop(K3.solve6),
                                                     reps=2)})
    K3.launches, K3.solve_launches = saved
    return res


def kernel_lm_solve(dev):
    """The LM solve kernel (K3 redesigned: one launch a solve): its update
    bit for bit against ``lm_propose`` with the kernel's LU on random
    proposals, then three solves from the identity at 512x640 -- B = 8 with
    20 iterations (an f2f window, K3's inputs), B = 1 with 100 (an f2m
    frame), and B = 8 noise-free with 100 (every sample done well before
    the cap: the device stops early)."""
    import torch

    from robust_pose_tpu_torch.ops import normal_eq as K3
    from robust_pose_tpu_torch.solver.gauss_newton import SolverConfig

    from robust_pose_tpu_torch import se3

    Hm, gv, lam, pose = propose_inputs(dev)
    got = K3.lm_update_device(Hm, gv, lam, pose)
    npose = se3.normalize(pose)
    ref = K3.lm_propose(Hm, gv, lam, pose, solve=K3.solve6_lu)
    ref = (*ref, torch.linalg.norm(ref[1], dim=-1), npose, se3.log(npose))
    differ = lambda x, y: (x.contiguous().view(torch.int32)
                           != y.contiguous().view(torch.int32)).reshape(len(x), -1).any(-1)
    diff = int((differ(got[0], ref[0]) | differ(got[1], ref[1])
                | differ(got[2], ref[2])).sum())
    diff_finish = int((differ(got[3], ref[3]) | differ(got[4], ref[4])).sum())
    require(diff == 0, f"lm_solve: {diff} of {len(Hm)} proposals differ from "
                       "lm_propose(solve=solve6_lu) and torch.linalg.norm")
    err_finish = max(float((got[3] - ref[3]).abs().max()),
                     float((got[4] - ref[4]).abs().max()))
    require(err_finish <= 1e-6, f"lm_solve: normalize/log off by {err_finish}")
    planes, kvec, lw, _ = solver_inputs(dev)
    cases = {"b8": solve_case(dev, "b8", planes, kvec, lw, SolverConfig(iters=20)),
             "b1": solve_case(dev, "b1", planes[:1].contiguous(), kvec[:1],
                              lw[:1], SolverConfig(iters=100))}
    planes, kvec, lw, _ = solver_inputs(dev, noise=False, seed=4)
    early = solve_case(dev, "early", planes, kvec, lw, SolverConfig(iters=100))
    require(max(early["niter"]) < 50 and all(early["done"]),
            f"lm_solve early: {early['niter']}")
    cases["early"] = early
    return {"proposals_checked": len(Hm), "proposals_differ": diff,
            "finish_differ": diff_finish, "finish_max_abs_err": err_finish,
            "cases": cases}


def lanewise_inputs(dev, centres="noisy", radius=4):
    """K4/K5 inputs at the training step's shapes: B = 3 x 8 RAFT pairs,
    N = 64 x 80 queries, the 4-level transposed bf16 volume of random
    C = 256 features, and centres with 200 queries a window off the level:
    ``noisy``, the identity plus 4 px of noise drawn per query (neighbouring
    windows decorrelated: the input of the rows on record since the kernels
    were first ported); ``smooth``, the identity plus a smooth flow field, an
    affine term and a sinusoid of 1.5-2 px with periods of 40 queries and
    more, which is what RAFT's GRU feeds the lookup in a training step."""
    import torch

    from robust_pose_tpu_torch.ops import corr_lanewise as L

    g = torch.Generator(device=dev).manual_seed(4)
    b, h8, w8, c = 3 * TRAIN_BATCH, H // 8, W // 8, 256
    f1 = torch.randn(b, h8, w8, c, generator=g, device=dev)
    f2 = torch.randn(b, h8, w8, c, generator=g, device=dev)
    pyramid = L.build_corr_pyramid_t(f1, f2, dtype=torch.bfloat16)
    ys, xs = torch.meshgrid(torch.arange(h8, device=dev, dtype=torch.float32),
                            torch.arange(w8, device=dev, dtype=torch.float32),
                            indexing="ij")
    noise = 4.0 * torch.randn(b, h8 * w8, 2, generator=g, device=dev)
    flow = smooth_flow(b, xs, ys).reshape(b, -1, 2) if centres == "smooth" else noise
    coords = torch.stack([xs, ys], -1).reshape(1, -1, 2) + flow
    coords[:, :200] -= 40.0
    grads = [torch.randn(b, (2 * radius + 1) ** 2, h8 * w8, generator=g,
                         device=dev) for _ in pyramid]
    return pyramid, coords.contiguous(), grads


def lanewise_small_inputs(dev, b, h8, w8, levels, dtype, seed=8, radius=4):
    """A small transposed pyramid (random C = 32 features), centres near the
    identity with a few queries far off the level, huge, infinite and NaN,
    and output cotangents."""
    import torch

    from robust_pose_tpu_torch.ops import corr_lanewise as L

    g = torch.Generator(device=dev).manual_seed(seed)
    f1 = torch.randn(b, h8, w8, 32, generator=g, device=dev)
    f2 = torch.randn(b, h8, w8, 32, generator=g, device=dev)
    pyramid = L.build_corr_pyramid_t(f1, f2, num_levels=levels, dtype=dtype)
    ys, xs = torch.meshgrid(torch.arange(h8, device=dev, dtype=torch.float32),
                            torch.arange(w8, device=dev, dtype=torch.float32),
                            indexing="ij")
    coords = torch.stack([xs, ys], -1).reshape(1, -1, 2) + 2.5 * torch.randn(
        b, h8 * w8, 2, generator=g, device=dev)
    coords[:, :8] -= 40.0
    coords[:, 8:12] = coords[:, 8:12] * 3.0 - 20.0
    coords[:, 12] = float("nan")
    coords[:, 13, 0] = float("nan")
    coords[:, 14, 1] = float("nan")
    coords[:, 15] = 1e30
    coords[:, 16] = float("-inf")
    coords[:, 17, 0] = float("inf")
    grads = [torch.randn(b, (2 * radius + 1) ** 2, h8 * w8, generator=g,
                         device=dev) for _ in pyramid]
    return pyramid, coords.contiguous(), grads


def grid_sample_yardstick(vols, coords, radius=4):
    """Upstream RAFT's CorrBlock lookup on the same volumes and centres:
    F.grid_sample(align_corners=True, zeros) over (B*N, 1, Hl, Wl) f32
    volumes with a D x D grid per query (dy-major). ``vols``: those f32
    volumes; returns them, the grids (made outside the timed call) and the
    call."""
    import torch
    import torch.nn.functional as F

    m = vols[0].shape[0]
    d = 2 * radius + 1
    dd = torch.arange(-radius, radius + 1, device=coords.device,
                      dtype=torch.float32)
    grids = []
    for lvl, v in enumerate(vols):
        hl, wl = v.shape[2:]
        c = coords.reshape(m, 1, 1, 2) / 2 ** lvl
        x = (c[..., 0] + dd[None, None, :]).expand(m, d, d)
        y = (c[..., 1] + dd[None, :, None]).expand(m, d, d)
        grids.append(torch.stack([2.0 * x / (wl - 1) - 1.0,
                                  2.0 * y / (hl - 1) - 1.0], -1).contiguous())

    def call(vols=vols, grids=grids):
        return [F.grid_sample(v, gr, mode="bilinear", padding_mode="zeros",
                              align_corners=True) for v, gr in zip(vols, grids)]

    return vols, grids, call


def lanewise_entries(pyramid, coords, grads, radius=4):
    """The calls of one 4-level lookup and of one 4-level backward, each
    returning per-level lists: kernel forward, plain forward, kernel
    backward, plain backward. The package's pyramid entries (one launch a
    call) where it has them; an earlier tree of the package, timed under
    this script for comparison, has one-level entries only."""
    import torch

    from robust_pose_tpu_torch.ops import corr_lanewise as L

    scales = [float(2 ** l) for l in range(len(pyramid))]
    dd = (2 * radius + 1) ** 2
    fwd_plain = lambda: [L.lanewise_fwd_plain(v, coords, radius, s)
                         for v, s in zip(pyramid, scales)]
    bwd_plain = lambda: [L.lanewise_bwd_plain(v, coords, g, radius, s)
                         for v, g, s in zip(pyramid, grads, scales)]
    if hasattr(L, "lanewise_fwd_pyramid"):
        gbuf = torch.cat(grads, dim=1)

        def fwd():
            return list(L.lanewise_fwd_pyramid(pyramid, coords, radius)
                        .split(dd, dim=1))

        def bwd():
            dcorrs, dcoords = L.lanewise_bwd_pyramid(pyramid, coords, gbuf,
                                                     radius)
            return dcorrs, dcoords
    else:
        fwd = lambda: [L.lanewise_fwd(v, coords, 4, s)
                       for v, s in zip(pyramid, scales)]

        def bwd():
            res = [L.lanewise_bwd(v, coords, g, 4, s)
                   for v, g, s in zip(pyramid, grads, scales)]
            return [r[0] for r in res], sum(r[1] for r in res[1:]) + res[0][1]
    return fwd, fwd_plain, bwd, bwd_plain


def lanewise_check(pyramid, coords, grads, what, radius=4):
    """K4 and K5 against their plain versions on these inputs. K4: the
    kernel rounds each product and sum as the plain version's separate
    multiplies and adds do (no FMA contraction): tol 1e-6. K5: dcorr rounds
    alike (tol 1e-6 of its largest); dcoords sums 100 products a window row
    and the levels in another order (1e-5 of the largest). Two calls give
    the same bits, and the backward writes every element of every dcorr: it
    is called right after NaN-filled tensors of the dcorrs' sizes were freed,
    so that its ``torch.empty`` hands it dirty memory. Returns the errors
    and scales."""
    import torch

    from robust_pose_tpu_torch.ops import corr_lanewise as L

    fwd, fwd_plain, bwd, bwd_plain = lanewise_entries(pyramid, coords, grads,
                                                      radius)
    out_k, out_p = fwd(), fwd_plain()
    err4 = lookup_err(out_k, out_p, f"{what}: lanewise forward")
    require(err4 <= 1e-6, f"{what}: lanewise forward max |err| {err4} > 1e-6")
    require(same_bits(out_k, fwd()), f"{what}: lanewise forward: two runs differ")
    if hasattr(L, "lanewise_fwd_pyramid"):
        require(len({o.untyped_storage().data_ptr() for o in out_k}) == 1,
                f"{what}: the levels are not views of one buffer")
    del out_k, out_p
    res_p = bwd_plain()
    ref_c = [p[0].float() for p in res_p]
    ref_x = sum(p[1] for p in res_p[1:]) + res_p[0][1]
    del res_p
    dirty = [torch.full_like(v, float("nan")) for v in pyramid]
    torch.cuda.synchronize()
    del dirty
    probe = [torch.empty_like(v) for v in pyramid]
    dirty_share = (sum(int(torch.isnan(p).sum()) for p in probe)
                   / max(1, sum(p.numel() for p in probe)))
    del probe
    dcorrs, dcoords = bwd()
    require(dirty_share > 0.9, f"{what}: the allocator handed out clean "
            f"memory ({dirty_share} dirty): the check of dcorr is void")
    got_c = [d.float() for d in dcorrs]
    require(all(d.dtype == v.dtype and d.shape == v.shape
                for d, v in zip(dcorrs, pyramid)), f"{what}: dcorr types")
    err5c = lookup_err(got_c, ref_c, f"{what}: lanewise dcorr")
    err5x = lookup_err([dcoords], [ref_x], f"{what}: lanewise dcoords")
    scale_c = max(float(r.abs().max()) for r in ref_c)
    scale_x = float(ref_x.abs().max())
    require(err5c <= 1e-6 * scale_c, f"{what}: lanewise dcorr max |err| {err5c}")
    require(err5x <= 1e-5 * scale_x, f"{what}: lanewise dcoords max |err| {err5x}")
    del got_c, ref_c
    again_c, again_x = bwd()
    same = all(torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16
                                  else torch.int32),
                           d.view(torch.int16 if d.dtype == torch.bfloat16
                                  else torch.int32))
               for a, d in zip(again_c, dcorrs))
    require(same and same_bits([again_x], [dcoords]),
            f"{what}: lanewise backward: two runs differ")
    return {"fwd": err4, "dcorr": err5c, "dcorr_tol": 1e-6 * scale_c,
            "dcoords": err5x, "dcoords_tol": 1e-5 * scale_x,
            "dirty_share": dirty_share}


def kernel_lanewise(dev, radius=4):
    """K4 and K5 at the training step's shapes (4 levels, one launch a
    call; radius 4 for RAFT large, 3 for RAFT small) at ``noisy`` and at
    ``smooth`` centres (see lanewise_inputs),
    against their plain versions on the card and timed beside upstream
    RAFT's grid_sample lookup and its autograd backward, with the device
    time of each level through the one-level entries; and on small cases
    that the kernels' tiles of 64 queries, pairs and 16-byte pieces make
    ragged (B = 3, 15 x 19: N = 285; 6 x 7: N = 42; 16 x 20: N = 320; f32
    and bf16; far-off, huge, infinite and NaN centres). The rows of the
    kernels line are the ``noisy`` ones, the input on record."""
    import torch

    from robust_pose_tpu_torch.ops import corr_lanewise as L

    saved = (L.launches, L.bwd_launches)
    one_launch = hasattr(L, "lanewise_fwd_pyramid")
    d = 2 * radius + 1
    small = {}
    for b, h8, w8, levels in ((3, 15, 19, 4), (2, 6, 7, 3), (2, 16, 20, 4)):
        for dtype in (torch.float32, torch.bfloat16):
            what = f"{b}x{h8}x{w8} {str(dtype).split('.')[-1]}"
            small[what] = lanewise_check(
                *lanewise_small_inputs(dev, b, h8, w8, levels, dtype,
                                       radius=radius), what, radius)
    per_input = {}
    for centres in ("noisy", "smooth"):
        pyramid, coords, grads = lanewise_inputs(dev, centres, radius)
        b, _, _, n = pyramid[0].shape
        errs = lanewise_check(pyramid, coords, grads, centres, radius)
        fwd, fwd_plain, bwd, bwd_plain = lanewise_entries(pyramid, coords, grads,
                                                          radius)
        t4 = measure(fwd, launches=1 if one_launch else None)
        t5 = measure(bwd, launches=1 if one_launch else None)
        if one_launch:
            require(t4["device_launches"] == 1 and t5["device_launches"] == 1,
                    f"lanewise: {t4['device_launches']} and "
                    f"{t5['device_launches']} device operations a call")
        levels4 = device_times_ms(
            [lambda l=l, v=v: L.lanewise_fwd(v, coords, radius, 2.0 ** l)
             for l, v in enumerate(pyramid)])
        levels5 = device_times_ms(
            [lambda l=l, v=v, g=g: L.lanewise_bwd(v, coords, g, radius, 2.0 ** l)
             for l, (v, g) in enumerate(zip(pyramid, grads))])
        plain4 = cuda_time_ms(fwd_plain, reps=3, warmup=1)
        plain5 = cuda_time_ms(bwd_plain, reps=3, warmup=1)
        vols, grids, lib = grid_sample_yardstick(
            [v.permute(0, 3, 1, 2).reshape(b * n, 1, *v.shape[1:3]).float()
             for v in pyramid], coords, radius)
        lib_err = max(float((o.reshape(b, n, d * d).transpose(1, 2) - p).abs().max())
                      for o, p in zip(lib(), fwd_plain()))
        lib4 = cuda_time_ms(lib, reps=5)
        lib4_device, _ = device_time_ms(lib, reps=5)
        vols = [v.requires_grad_() for v in vols]
        grids = [gr.requires_grad_() for gr in grids]
        outs = lib(vols, grids)
        gouts = [g.transpose(1, 2).reshape(o.shape).contiguous()
                 for g, o in zip(grads, outs)]
        lib_bwd = lambda: torch.autograd.grad(outs, vols + grids, gouts,
                                              retain_graph=True)
        lib5 = cuda_time_ms(lib_bwd, reps=5)
        lib5_device, _ = device_time_ms(lib_bwd, reps=5)
        del vols, grids, outs, gouts, lib, lib_bwd
        taps = window_taps([v.shape[1:3] for v in pyramid], coords, radius)
        vol_bytes = sum(v.numel() * v.element_size() for v in pyramid)
        # what writing dcorr's bytes once costs at the least: one zero fill
        fill = torch.empty(vol_bytes // 2, dtype=torch.bfloat16, device=dev)
        zero_fill_ms, _ = device_time_ms(fill.zero_)
        del fill
        ops4, bytes4, _ = costs.lanewise_fwd(pyramid, coords, radius)
        ops5, bytes5, _ = costs.lanewise_bwd(pyramid, coords, radius)
        rows = []
        for t, plain, lib_ms, lib_dev, levels, nbytes, ops in (
                (t4, plain4, lib4, lib4_device, levels4, bytes4, ops4),
                (t5, plain5, lib5, lib5_device, levels5, bytes5, ops5)):
            bound, by = costs.bound(nbytes, {"f32": ops})
            rows.append({**t, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                         "library_ms": lib_ms, "library_device_ms": lib_dev,
                         "level_device_ms": levels, "bytes": nbytes, "ops": ops,
                         "taps_in_level": taps, "centres": centres})
        rows[0]["library_max_abs_diff"] = lib_err
        rows[1]["zero_fill_device_ms"] = zero_fill_ms
        per_input[centres] = (rows, errs)
        del pyramid, coords, grads, fwd, fwd_plain, bwd, bwd_plain
        torch.cuda.empty_cache()
    L.launches, L.bwd_launches = saved
    n_launch = "1 launch" if one_launch else "4 launches"
    tail = "" if radius == 4 else f"_r{radius}"
    out = []
    for k, (name, line, unit) in enumerate((
            ("lanewise_lookup" + tail, 72,
             f"one 4-level lookup, radius {radius} ({n_launch})"),
            ("lanewise_lookup_bwd" + tail, 153,
             f"one 4-level lookup backward, radius {radius} ({n_launch})"))):
        worst = max([per_input[c][1] for c in per_input] + list(small.values()),
                    key=lambda e: e["fwd"] if k == 0 else max(e["dcorr"], e["dcoords"]))
        out.append({"name": name, "route": "cuda",
                    "source": "robust_pose_tpu_torch/csrc/corr_lanewise.cu",
                    "replaces": f"robust_pose_tpu/ops/pallas_lookup_lanewise.py:{line}",
                    "max_abs_err": worst["fwd"] if k == 0
                    else max(worst["dcorr"], worst["dcoords"]),
                    **per_input["noisy"][0][k], "unit": unit,
                    "per_input": {c: per_input[c][0][k] for c in per_input},
                    "err": {c: per_input[c][1] for c in per_input},
                    "err_small": small})
    return out


def pixel_inputs(dev, b, h8, w8, dtype, centres="near", seed=6):
    """K6/K7 inputs: the 4-level all-pairs volume (B, N, Hl, Wl) of random
    C = 256 features (RAFT's build_corr_pyramid) and centres (B, H, W, 2):
    ``near`` the identity with 200 queries a window off the level; ``far``,
    3 x base - 50 (most windows wholly or partly off); ``ragged``, near the
    identity with a few queries far off, huge, infinite and NaN."""
    import torch

    from robust_pose_tpu_torch.models.raft import build_corr_pyramid

    g = torch.Generator(device=dev).manual_seed(seed)
    f1 = torch.randn(b, h8, w8, 256, generator=g, device=dev)
    f2 = torch.randn(b, h8, w8, 256, generator=g, device=dev)
    pyramid = build_corr_pyramid(f1, f2, dtype=dtype)
    ys, xs = torch.meshgrid(torch.arange(h8, device=dev, dtype=torch.float32),
                            torch.arange(w8, device=dev, dtype=torch.float32),
                            indexing="ij")
    base = torch.stack([xs, ys], -1)[None].expand(b, h8, w8, 2)
    if centres == "far":
        coords = base * 3.0 - 50.0
    else:
        coords = base + 4.0 * torch.randn(b, h8, w8, 2, generator=g, device=dev)
        flat = coords.view(b, -1, 2)
        if centres == "near":
            flat[:, :200] -= 40.0
        else:
            flat[:, :20] -= 40.0
            flat[:, 30] = float("nan")
            flat[:, 31, 0] = float("nan")
            flat[:, 32, 1] = float("nan")
            flat[:, 33] = 1e30
            flat[:, 34] = float("-inf")
    return pyramid, coords.contiguous()


def pixel_lookup_plain(pyramid, coords):
    """The plain K6/K7 on every level, in the pyramid wrappers' (B, 81, N)
    layout."""
    from robust_pose_tpu_torch.ops import corr_pixel as KP

    b, n = pyramid[0].shape[:2]
    c = coords.reshape(b * n, 2)
    return [KP.pixel_lookup_level_plain(v.reshape(b * n, *v.shape[2:]), c / 2 ** l)
            .reshape(b, n, 81).transpose(1, 2) for l, v in enumerate(pyramid)]


def lookup_err(got, ref, what):
    """max |got - ref| over two lists of f32 tensors whose NaNs (a NaN
    centre's outputs) must sit at the same places."""
    import torch

    worst = 0.0
    for g, r in zip(got, ref):
        require(g.shape == r.shape and g.dtype == torch.float32,
                f"{what}: {tuple(g.shape)} {g.dtype} vs {tuple(r.shape)}")
        nan = torch.isnan(r)
        require(torch.equal(torch.isnan(g), nan), f"{what}: NaNs differ")
        worst = max(worst, float(torch.where(nan, 0.0, g - r).abs().max()))
    return worst


def same_bits(a, b):
    import torch

    return all(torch.equal(x.contiguous().view(torch.int32),
                           y.contiguous().view(torch.int32)) for x, y in zip(a, b))


def kernel_pixel(dev):
    """K6 and K7 at the f2m path's shapes: the temporal step (B = 1) and the
    batched precompute (B = T = 8), N = 64 x 80 queries, bf16 volumes, all
    4 levels in one launch; plus a small f32 case with far-off centres and
    a ragged bf16 case (B = 3, 15 x 19: N no multiple of 32 or 8, a 1 x 2
    coarsest level, NaN and infinite centres), both in the pyramid's
    (B, 81, N) layout and the level functions' (M, 81). Each against the
    plain version (the kernels round as it does: tol 1e-6) and twice for
    the same bits, timed beside upstream RAFT's grid_sample lookup on the
    same volumes and beside an empty kernel's launch."""
    import torch

    from robust_pose_tpu_torch.ops import corr_pixel as KP

    saved = (KP.launches, KP.grouped_launches)
    fns = {"pixel_lookup": (KP.pixel_lookup_pyramid, KP.pixel_lookup_level),
           "grouped_lookup": (KP.grouped_lookup_pyramid, KP.grouped_lookup_level)}
    tol = 1e-6
    err = {k: 0.0 for k in fns}

    def check(pyramid, coords, levels):
        """Both kernels against the plain version on these inputs, in the
        pyramid layout and, with ``levels``, level by level in (M, 81)."""
        b, n = pyramid[0].shape[:2]
        ref = pixel_lookup_plain(pyramid, coords)
        for name, (pyr_fn, lvl_fn) in fns.items():
            got = pyr_fn(pyramid, coords)
            require(len({g.untyped_storage().data_ptr() for g in got}) == 1
                    and all(g.shape == (b, 81, n) for g in got),
                    f"{name}: the levels are not views of one buffer")
            require(same_bits(got, pyr_fn(pyramid, coords)),
                    f"{name}: two runs differ")
            err[name] = max(err[name], lookup_err(got, ref, name))
            if not levels:
                continue
            vols = [v.reshape(b * n, *v.shape[2:]) for v in pyramid]
            cs = [coords.reshape(b * n, 2) / 2 ** l for l in range(len(vols))]
            got = [lvl_fn(v, c) for v, c in zip(vols, cs)]
            require(same_bits(got, [lvl_fn(v, c) for v, c in zip(vols, cs)]),
                    f"{name}: two runs differ (level layout)")
            err[name] = max(err[name], lookup_err(
                got, [r.transpose(1, 2).reshape(b * n, 81) for r in ref], name))
        return ref

    ref = check(*pixel_inputs(dev, 2, 16, 20, torch.float32, "far"), levels=True)
    require(any(bool((r != 0).any()) for r in ref), "pixel lookup: far case all zero")
    ref = check(*pixel_inputs(dev, 3, 15, 19, torch.bfloat16, "ragged"), levels=True)
    require(all(bool(torch.isnan(r).any()) for r in ref)
            and tuple(ref[-1].shape) == (3, 81, 285),
            "pixel lookup: the ragged case lost its NaN centres")
    on_card = torch.empty(0, device=dev)
    empty = measure(lambda: KP.noop_launch(on_card))
    per_shape = {k: [] for k in fns}
    for b in (1, T_WINDOW):
        pyramid, coords = pixel_inputs(dev, b, H // 8, W // 8, torch.bfloat16)
        n = pyramid[0].shape[1]
        check(pyramid, coords, levels=False)
        plain_ms = cuda_time_ms(lambda: pixel_lookup_plain(pyramid, coords),
                                reps=3, warmup=1)
        vols, grids, lib = grid_sample_yardstick(
            [v.reshape(b * n, 1, *v.shape[2:]).float() for v in pyramid], coords)
        lib_ms = cuda_time_ms(lib, reps=5)
        lib_device_ms, _ = device_time_ms(lib)
        del vols, grids, lib
        taps = window_taps([v.shape[2:] for v in pyramid], coords.reshape(b, n, 2))
        ops, nbytes, _ = costs.pixel_lookup(
            [v.reshape(b * n, *v.shape[2:]) for v in pyramid],
            coords.reshape(b * n, 2))
        bound, by = costs.bound(nbytes, {"f32": ops})
        vol0 = pyramid[0].reshape(b * n, *pyramid[0].shape[2:])
        c0 = coords.reshape(b * n, 2)
        for name, (pyr_fn, lvl_fn) in fns.items():
            t = measure(lambda: pyr_fn(pyramid, coords))
            require(t["device_launches"] <= 1,
                    f"{name}: {t['device_launches']} device launches a pyramid")
            per_shape[name].append({
                "batch": b, **t, "plain_ms": plain_ms, "library_ms": lib_ms,
                "library_device_ms": lib_device_ms,
                # level 0 alone in the level functions' (M, 81) layout
                "level0_m81_device_ms": device_time_ms(lambda: lvl_fn(vol0, c0))[0],
                "bound_ms": bound, "bound_by": by,
                "bytes": nbytes, "ops": ops, "taps_in_level": taps})
        del pyramid, coords, vol0, c0
        torch.cuda.empty_cache()
    KP.launches, KP.grouped_launches = saved
    for name in fns:
        require(err[name] <= tol, f"{name}: max |err| {err[name]} > {tol}")
    out = []
    for name, line in (("pixel_lookup", 47), ("grouped_lookup", 159)):
        step = per_shape[name][0]                  # the temporal step, B = 1
        out.append({"name": name, "route": "cuda",
                    "source": "robust_pose_tpu_torch/csrc/corr_pixel.cu",
                    "replaces": f"robust_pose_tpu/ops/pallas_lookup.py:{line}",
                    "max_abs_err": err[name], "tol": tol,
                    **{k: step[k] for k in ("ms", "device_ms", "host_us",
                                            "device_launches", "plain_ms",
                                            "bound_ms", "bound_by", "library_ms")},
                    "unit": "one 4-level lookup at B = 1 (1 launch)",
                    "empty_launch": empty, "per_shape": per_shape[name]})
    return out


def phase_kernels(dev):
    import torch

    t0 = time.perf_counter()
    k3 = kernel_normal_eq(dev)
    k3["solve"] = kernel_lm_solve(dev)
    out = [kernel_corr(dev), *kernel_instance_norm(dev), k3,
           *kernel_lanewise(dev), *kernel_pixel(dev),
           # RAFT small: K1, K4, K5 at radius 3, K2 at its fnet's widths
           kernel_corr(dev, 3, 128, K1_CASES[:3]),
           *kernel_instance_norm(dev, (32, 64, 96)), *kernel_lanewise(dev, 3)]
    torch.cuda.synchronize()
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0,
          "profiler_retries": profiling.profiler_retries, "kernels": out})
    return out


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def small_state_dict(model_cfg, seed):
    import torch

    from robust_pose_tpu_torch.models.posenet import PoseNet

    m = PoseNet(model_cfg, device="cpu")
    m.reset_parameters(torch.Generator().manual_seed(seed))
    sd = m.state_dict()
    head = "flow.update.update_block.flow_head.conv2."
    sd[head + "weight"] = 0.1 * sd[head + "weight"]       # damped, biased head:
    sd[head + "bias"] = torch.tensor([-0.1, 0.0])        # ~-1.5 px flows
    return sd


def phase_slice(dev, small=False):
    """64x96, f32, the same weights and frames on the card (kernels) and on
    the CPU (plain versions); tolerances of tests/test_torch_port_slice.py.
    ``small``: RAFT's small variant (K1 at radius 3, C = 128), the f2f half
    of phase small_slice. Returns the card's model config and weights."""
    import torch

    from robust_pose_tpu_torch.slam.pose_estimator import PoseEstimator

    h, w = 64, 96
    model_cfg = {"image_shape": (h, w), "iters": 2, "lbgfs_iters": 5,
                 "use_weights": True, "mixed_precision": False, "unet_levels": 1,
                 "lookup": "onthefly",       # K1 on the card, its plain version here
                 "small": small}
    slam = {"frame2frame": True, "lbgfs_iters": 5, "conf_weighing": True,
            "depth_clipping": [1, 250]}
    K = np.array([[100.0, 0, w / 2], [0, 100.0, h / 2], [0, 0, 1.0]])
    sd = small_state_dict(model_cfg, seed=11)
    ls, rs = make_sequence(5, disparity=3, step=2, seed=5, h=h, w=w)
    mask = np.ones((1, h, w, 1), bool)
    res = {}
    for where in ("cuda", "cpu"):
        est = PoseEstimator(slam, K, 250.0, {"state_dict": sd,
                                            "config": {"model": model_cfg}},
                            (w, h), device=where if where == "cpu" else dev)
        zero_launch_counts()
        est(ls[0], rs[0], mask)
        first_mask = est.frame.depth.cpu() < 249.999
        poses, succ = [], []
        for lo in (1, 3):
            p, s = est.track_window(ls[lo:lo + 2], rs[lo:lo + 2],
                                    np.stack([mask] * 2))
            poses.append(p.cpu())
            succ.append(s.cpu())
        res[where] = {"poses": torch.cat(poses), "succ": torch.cat(succ),
                      "first_valid": first_mask,
                      "carry_valid": est.frame.depth.cpu() < 249.999,
                      "niter": est.last_solver_iters.cpu(),
                      "k1": launch_counts()["corr_window_lookup"]}
    c, p = res["cuda"], res["cpu"]
    dist = tangent_distance(c["poses"], p["poses"])
    require(bool(p["succ"].any()), "slice: degenerate sequence, every frame failed")
    require(torch.equal(c["succ"], p["succ"]), "slice: success flags differ")
    require(torch.equal(c["first_valid"], p["first_valid"])
            and torch.equal(c["carry_valid"], p["carry_valid"]),
            "slice: depth-valid masks differ")
    require(dist <= 1e-4, f"slice: pose tangent distance {dist} > 1e-4")
    require(c["k1"] > 0 and p["k1"] == 0, f"slice: K1 launches {c['k1']}, {p['k1']}")
    emit({"phase": "small_slice" if small else "slice", "part": "f2f",
          "shape": [h, w], "pose_tangent_dist": dist,
          "k1_launches_cuda": c["k1"],
          "tol": 1e-4, "success": c["succ"].tolist(),
          "niter_cuda": c["niter"].tolist(), "niter_cpu": p["niter"].tolist(),
          "valid_fraction": float(c["first_valid"].float().mean())})
    return model_cfg, sd, slam, K, (ls, rs, mask)


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

F2F_SLAM = {"frame2frame": True, "lbgfs_iters": 20, "conf_weighing": True,
            "depth_clipping": [1, 250], "dist_thr": 0.05, "average_pts": False}


def production_estimator(dev, mixed_precision, state_dict=None, disparity=8,
                         slam=F2F_SLAM, lookup=None, small=False):
    """A full-width PoseEstimator (12 GRU iterations, weight heads, 3 UNet
    levels; ``small``: RAFT's small variant) for the SLAM config ``slam``;
    random seeded weights with bench.py's flow head (zero kernel, bias =
    disparity / (8 * iters)) unless ``state_dict`` is given."""
    from robust_pose_tpu_torch.slam.pose_estimator import PoseEstimator

    model_cfg = production_model_cfg(slam, mixed_precision, lookup, small)
    if state_dict is None:
        state_dict = production_weights(dev, model_cfg, disparity)
    est = PoseEstimator(slam, PRODUCTION_K, PRODUCTION_BF,
                        {"state_dict": state_dict,
                         "config": {"model": model_cfg}}, (W, H), device=dev)
    return est, state_dict


PRODUCTION_K = np.array([[FX, 0.0, W / 2], [0.0, FX, H / 2], [0.0, 0.0, 1.0]])
PRODUCTION_BF = 16.0          # stereo baseline x focal length, pixels


def production_model_cfg(slam=F2F_SLAM, mixed_precision=True, lookup=None,
                          small=False):
    """The full-width model config of production_estimator."""
    model_cfg = {"image_shape": (H, W), "iters": 12,
                 "lbgfs_iters": slam["lbgfs_iters"], "use_weights": True,
                 "unet_levels": 3, "mixed_precision": mixed_precision,
                 "small": small}
    if lookup is not None:
        model_cfg["lookup"] = lookup
    return model_cfg


def production_weights(dev, model_cfg, disparity=8):
    """Random seeded weights for ``model_cfg`` with bench.py's flow head
    (zero kernel, bias = disparity / (8 * iters)), on the CPU."""
    import torch

    from robust_pose_tpu_torch.models.posenet import PoseNet

    m = PoseNet(model_cfg, device=dev)
    m.reset_parameters(torch.Generator().manual_seed(0))
    fh = m.flow.update["update_block"].flow_head.conv2
    with torch.no_grad():
        fh.weight.zero_()
        fh.bias.copy_(torch.tensor([-disparity / (8.0 * 12), 0.0]))
    return {k: v.cpu() for k, v in m.state_dict().items()}


MAIN_FPS = {}                 # phase main's (and small's) f2f FPS of this run
F2M_FPS = {}                  # phase f2m's FPS of this run


def phase_main(dev, smi, small=False):
    """Production f2f at full width (``small``: RAFT's small variant, the
    f2f half of phase small), then its profile."""
    import torch

    from robust_pose_tpu_torch import se3

    what = "small" if small else "main"
    est, sd = production_estimator(dev, True, small=small)
    ls, rs = make_sequence(1)
    mask1 = np.ones((1, H, W, 1), bool)
    est(ls[0], rs[0], mask1)
    masks = torch.ones((T_WINDOW, 1, H, W, 1), dtype=torch.bool, device=dev)
    n_timed = N_TIMED
    windows = []
    for i in range(n_timed + 2):
        l, r = make_sequence(T_WINDOW, seed=1 + i)
        windows.append((torch.from_numpy(l).to(dev), torch.from_numpy(r).to(dev)))
    for i in (-1, -2):                                     # warm-up
        est.track_window(windows[i][0], windows[i][1], masks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_launch_counts()
    t0 = time.perf_counter()
    succs, poses = [], None
    for i in range(n_timed):
        poses, succ = est.track_window(windows[i][0], windows[i][1], masks)
        succs.append(succ)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts().items() if k in (
        "corr_window_lookup", "instance_norm", "instance_norm_stats", "normal_eq",
        "lm_solve")}

    require(bool(torch.isfinite(poses).all()), f"{what}: non-finite poses")
    require(launches["corr_window_lookup"] == 12 * n_timed,
            f"{what}: corr lookups {launches}")
    # 15 instance norms in fnet (both variants), one K2 call each, no
    # statistics call alone (no backward); cnet has BatchNorm (large) or
    # no norm (small)
    require(launches["instance_norm"] == 15 * n_timed
            and launches["instance_norm_stats"] == 0,
            f"{what}: instance norms {launches}")
    # one LM solve launch a window (every build inside it)
    one_solve_a_call(launches, what)
    require(launches["lm_solve"] == n_timed, f"{what}: LM solves {launches}")
    succ = torch.cat(succs)
    it = est.last_solver_iters.cpu()
    fps = n_timed * T_WINDOW / dt
    if small:
        require(bool(succ.all()), f"small: success {succ.tolist()}")

    # bf16 vs f32 on one window from the same first frame and weights
    rel = {}
    for mp in (True, False):
        e, _ = production_estimator(dev, mp, state_dict=sd, small=small)
        e(ls[0], rs[0], mask1)
        p, _ = e.track_window(windows[0][0], windows[0][1], masks)
        prev = torch.cat([e.last_pose.new_tensor([[0, 0, 0, 0, 0, 0, 1.0]]),
                          p[:-1, 0]])
        rel[mp] = se3.mul(se3.inv(p[:, 0]), prev)            # per-frame rel
        del e
    deltas = [tangent_distance(rel[True][i:i + 1], rel[False][i:i + 1])
              for i in range(T_WINDOW)]
    require(max(deltas) < 2e-2, f"{what}: bf16-vs-f32 pose deltas {deltas}")
    MAIN_FPS[what] = fps
    emit({"phase": what, "part": "f2f", "card": smi, "shape": [H, W],
          "window": T_WINDOW, "small": small,
          "timed_windows": n_timed, "fps": fps, "seconds": dt,
          "success_rate": float(succ.float().mean()),
          "lm_iters": {"mean": float(it.float().mean()), "max": int(it.max()),
                       "min": int(it.min())},
          "launches": launches,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "bf16_vs_f32_pose_delta": deltas})
    phase_profile(est, windows[0], masks, what)
    return launches


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

def k1_in_window(prof, earlier=None):
    """K1's device ms in a profiled window or step (its kernel group),
    beside the figure on record before its redesign where there is one."""
    return {"ms": prof.get("group_ms", {}).get("corr_window_lookup (K1)"),
            "earlier": earlier}


def solve_span(prof, span, solves, earlier):
    """The LM solve's span in a profiled run: its stage's device ms and
    kernel ms (up to the next span: in f2m the estimator's per-frame code
    after the solve counts too), and the launches a solve inside the span
    itself (pack_planes, the solve kernel; at most 40), beside the figures
    on record for the host-driven loop."""
    st = prof.get("stages", {}).get(span)
    if st is None:
        return {"span": span, "device_time": "not measured"}
    per = st["in_span_launches"] / solves
    require(per <= 40, f"{span}: {per} launches a solve")
    return {"span": span, "solves": solves, "device_ms": st["device_ms"],
            "kernel_ms": st["kernel_ms"], "stage_launches": st["launches"],
            "launches_per_solve": per, "earlier": earlier}


def phase_profile(est, window, masks, what="main"):
    """One more main-path window under torch.profiler, by stage of
    PoseNet.infer_window."""
    prof = profile_run(lambda: est.track_window(window[0], window[1], masks),
                       "infer_window.")
    # before the redesign (48 launches a window): 43.91 ms of the flow
    # span's 86.60; before the one-launch LM solve the solve span held the
    # card 81.0-109.0 ms for 7.3 ms of kernels, 3,075 launches a window
    # (NVIDIA H100 80GB HBM3, 700 W)
    emit({"phase": "profile", "path": what, "window": T_WINDOW, **prof,
          "k1_in_window": k1_in_window(prof, {"flow_span_k1_ms": 43.91}),
          "solve_span": solve_span(prof, "infer_window.solve", 1, {
              "device_ms": [81.0, 109.0], "kernel_ms": 7.3, "launches": 3075})})


# ---------------------------------------------------------------------------
# phases 6 and 7
# ---------------------------------------------------------------------------

def spy_grads(trainer):
    """Record the gradients the trainer's optimizer receives."""
    seen = []
    update = trainer.optimizer.update

    def spy(params, grads, opt_state):
        seen.append({k: None if g is None else g.detach().float().cpu().clone()
                     for k, g in grads.items()})
        return update(params, grads, opt_state)

    trainer.optimizer.update = spy
    return seen


def launch_counts():
    from robust_pose_tpu_torch.ops import corr_lanewise as L
    from robust_pose_tpu_torch.ops import corr_onthefly as K1
    from robust_pose_tpu_torch.ops import corr_pixel as KP
    from robust_pose_tpu_torch.ops import instance_norm as K2
    from robust_pose_tpu_torch.ops import normal_eq as K3

    return {"corr_window_lookup": K1.launches, "instance_norm": K2.launches,
            "instance_norm_stats": K2.stats_launches,
            "normal_eq": K3.launches, "lm_solve": K3.solve_launches,
            "lanewise_lookup": L.launches,
            "lanewise_lookup_bwd": L.bwd_launches, "pixel_lookup": KP.launches,
            "grouped_lookup": KP.grouped_launches}


SOLVE_CALLS = [0]             # solve_pose calls (count_solve_pose)


def count_solve_pose():
    """Count every ``solver.gauss_newton.solve_pose`` call (PoseNet's and
    the pose layer's) in SOLVE_CALLS, so a phase can hold the solve
    kernel to exactly one launch a call."""
    from robust_pose_tpu_torch.models import posenet
    from robust_pose_tpu_torch.solver import gauss_newton as GN

    inner = GN.solve_pose
    if getattr(inner, "counted", False):
        return

    def counted(*args, **kw):
        SOLVE_CALLS[0] += 1
        return inner(*args, **kw)

    counted.counted = True
    GN.solve_pose = posenet.solve_pose = counted


def one_solve_a_call(lc, what):
    """The solve kernel ran once for every solve_pose call since the
    counters were zeroed, and no K3 build was launched from Python."""
    require(lc["lm_solve"] == SOLVE_CALLS[0] > 0 and lc["normal_eq"] == 0,
            f"{what}: {lc['lm_solve']} solve launches, {SOLVE_CALLS[0]} "
            f"solve_pose calls, {lc['normal_eq']} K3 builds")


def zero_launch_counts():
    from robust_pose_tpu_torch.ops import corr_lanewise as L
    from robust_pose_tpu_torch.ops import corr_onthefly as K1
    from robust_pose_tpu_torch.ops import corr_pixel as KP
    from robust_pose_tpu_torch.ops import instance_norm as K2
    from robust_pose_tpu_torch.ops import normal_eq as K3

    K1.launches = K2.launches = K2.stats_launches = 0
    K3.launches = K3.solve_launches = 0
    L.launches = L.bwd_launches = 0
    KP.launches = KP.grouped_launches = 0
    SOLVE_CALLS[0] = 0


def restore_launch_counts(lc):
    """Set the launch counters to ``lc`` (a ``launch_counts()``)."""
    from robust_pose_tpu_torch.ops import corr_lanewise as L
    from robust_pose_tpu_torch.ops import corr_onthefly as K1
    from robust_pose_tpu_torch.ops import corr_pixel as KP
    from robust_pose_tpu_torch.ops import instance_norm as K2
    from robust_pose_tpu_torch.ops import normal_eq as K3

    K1.launches, K2.launches = lc["corr_window_lookup"], lc["instance_norm"]
    K2.stats_launches = lc["instance_norm_stats"]
    K3.launches, K3.solve_launches = lc["normal_eq"], lc["lm_solve"]
    L.launches, L.bwd_launches = lc["lanewise_lookup"], lc["lanewise_lookup_bwd"]
    KP.launches, KP.grouped_launches = lc["pixel_lookup"], lc["grouped_lookup"]


def replay_dropout(record):
    """Patch the port's dropout draw: with ``record`` a list, record every
    keep mask drawn (the card's run); with ``record`` a list of masks, hand
    them out again in order on the device asked for (the CPU run), so both
    runs drop the same channels. Returns the undo."""
    from robust_pose_tpu_torch.models import raft as raft_mod

    draw = raft_mod.dropout_keep
    replay = list(record)

    def keep(batch, channels, p, generator):
        if replay:
            return replay.pop(0).to(generator.device)
        k = draw(batch, channels, p, generator)
        record.append(k.cpu())
        return k

    raft_mod.dropout_keep = keep
    return lambda: setattr(raft_mod, "dropout_keep", draw)


def dropout_mask_check(dev, model, images, p):
    """On the card, each encoder of ``model`` (small, f32) with a keep mask
    against itself without one: every (sample, channel) of the output is
    all zero or the eval output times 1 / (1 - p) (rtol 1e-6); and the
    kept share of the masks drawn lies within 4 binomial standard
    deviations of 1 - p. Returns the kept shares."""
    import torch

    from robust_pose_tpu_torch.models import raft as raft_mod

    g = torch.Generator(device=dev).manual_seed(3)
    shares = {}
    with torch.no_grad():
        x = model.flow._prep(images)
        for name in ("fnet", "cnet"):
            net = getattr(model.flow, name)
            keep = raft_mod.dropout_keep(x.shape[0], net.conv2.out_channels, p, g)
            ref, out = net(x).float(), net(x, keep).float()
            k = keep.expand_as(out)
            dropped_ok = bool((out[~k] == 0).all())
            err = float(((out - ref / (1.0 - p)).abs()
                         / (ref.abs() / (1.0 - p) + 1e-6))[k].max())
            share = float(keep.float().mean())
            n = keep.numel()
            require(dropped_ok and err <= 1e-6
                    and abs(share - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / n),
                    f"dropout {name}: dropped zero {dropped_ok}, kept rel err "
                    f"{err}, share {share} of {n}")
            shares[name] = share
    return shares


def phase_train_slice(dev, small=False):
    """One live-RAFT training step (lane-wise lookup) at 64x96 in f32 on
    the card and on the CPU from the same weights and batch; ``small``:
    RAFT's small variant (K4/K5 at radius 3) with remat and remat_policy
    "dots" and dropout 0.1, the CPU run replaying the card's dropout masks
    (the training half of phase small_slice). Loss rtol
    1e-4; every gradient within 5e-3 of its leaf's norm in L2 and within
    5e-2 of its leaf's largest element (a pixel whose depth validity or
    flow bound sits on a threshold can fall on either side on the two
    devices and move a few elements of a high-resolution encoder kernel by
    ~1%), each plus 2e-5 of the largest of all; updated parameters within
    1e-3 lr where the gradient is above twice its elementwise tolerance
    and within 2 lr everywhere."""
    import torch

    from robust_pose_tpu_torch.train.trainer import PoseNetTrainer

    h, w, b, lr = 64, 96, 2, 1e-4
    model_cfg = {"iters": 2, "lbgfs_iters": 50, "use_weights": True,
                 "mixed_precision": False, "unet_levels": 1, "dropout": 0.0,
                 "lookup": "lanewise"}
    if small:
        model_cfg.update(small=True, dropout=0.1, remat=True,
                         remat_policy="dots")
    cfg = {"model": model_cfg, "image_shape": [h, w],
           "train": {"learning_rate": lr, "weight_decay": 5e-5,
                     "epsilon": 1e-8, "grad_clip": 1.0, "freeze_flow_steps": 0}}
    sd = small_state_dict(dict(model_cfg, image_shape=(h, w)), seed=21)
    rng = np.random.default_rng(1)
    img = lambda: rng.uniform(0, 255, (b, 3, h, w)).astype(np.float32)
    gt = np.zeros((b, 7), np.float32)
    gt[:, 6], gt[:, 0] = 1.0, 0.01
    K = np.tile(np.float32([[100.0, 0, w / 2], [0, 100.0, h / 2], [0, 0, 1]]),
                (b, 1, 1))
    mask = np.ones((b, 1, h, w), bool)
    batch = (img(), img(), img(), img(), mask, mask, gt, K,
             np.ones((b,), np.float32))
    res = {}
    masks = []
    for where in ("cuda", "cpu"):
        tr = PoseNetTrainer(cfg, device=dev if where == "cuda" else "cpu")
        st = tr.init_state(sd)
        seen = spy_grads(tr)
        zero_launch_counts()
        undo = replay_dropout(masks if where == "cuda" else list(masks))
        try:
            st, m = tr.train_step(st, batch)
        finally:
            undo()
        res[where] = {"loss": float(m["train/loss_total"]),
                      "grad_norm": float(m["train/grad_norm"]),
                      "grads": seen[0], "launches": launch_counts(),
                      "solves": SOLVE_CALLS[0],
                      "params": {k: v.detach().cpu() for k, v in st.params.items()}}
    c, p = res["cuda"], res["cpu"]
    require(abs(c["loss"] - p["loss"]) <= 1e-4 * abs(p["loss"]),
            f"train_slice: loss {c['loss']} vs {p['loss']}")
    live = [g for g in p["grads"].values() if g is not None]
    floor = 2e-5 * max(float(g.abs().max()) for g in live)
    floor2 = 2e-5 * max(float(g.norm()) for g in live)
    worst = {"grad_l2": 0.0, "grad_max": 0.0, "param": 0.0}
    for k, gp in p["grads"].items():
        gc = c["grads"][k]
        require((gc is None) == (gp is None), f"train_slice: gradient of {k}")
        if gp is None:
            continue
        tol2 = 5e-3 * float(gp.norm()) + floor2
        err2 = float((gc - gp).norm())
        require(err2 <= tol2, f"train_slice: gradient of {k}: L2 {err2} > {tol2}")
        atol = 5e-2 * float(gp.abs().max()) + floor
        err = float((gc - gp).abs().max())
        require(err <= atol, f"train_slice: gradient of {k}: {err} > {atol}")
        worst["grad_l2"] = max(worst["grad_l2"], err2 / tol2)
        worst["grad_max"] = max(worst["grad_max"], err / atol)
        d = (c["params"][k] - p["params"][k]).abs()
        big = gp.abs() > 2 * atol
        require(float(d.max()) <= 2 * lr, f"train_slice: update of {k}")
        if bool(big.any()):
            require(float(d[big].max()) <= 1e-3 * lr, f"train_slice: update of {k}")
            worst["param"] = max(worst["param"], float(d[big].max()) / (1e-3 * lr))
    require(p["grads"]["flow.fnet.conv1.weight"].abs().max() > 0,
            "train_slice: no RAFT gradient")
    lc = c["launches"]
    require(lc["lanewise_lookup"] > 0 and lc["lanewise_lookup_bwd"] > 0
            and lc["instance_norm"] > 0 and lc["instance_norm_stats"] > 0
            and lc["lm_solve"] == 1 and lc["normal_eq"] == 0 and c["solves"] == 1
            and lc["corr_window_lookup"] == 0, f"train_slice: launches {lc}")
    require(not any(p["launches"].values()), f"train_slice: CPU launches")
    extra = {}
    if small:
        require(len(masks) == 2, f"train_slice: {len(masks)} dropout masks drawn")
        extra["dropout_keep_share"] = dropout_mask_check(
            dev, PoseNetTrainer(cfg, device=dev).model,
            torch.from_numpy(batch[0]).permute(0, 2, 3, 1).to(dev), 0.1)
    emit({"phase": "small_slice" if small else "train_slice", "part": "train",
          "model": model_cfg, **extra, "shape": [h, w], "batch": b,
          "loss_cuda": c["loss"], "loss_cpu": p["loss"],
          "grad_norm_cuda": c["grad_norm"], "grad_norm_cpu": p["grad_norm"],
          "worst_error_over_tolerance": worst, "launches_cuda": lc})


def train_batch_full(dev, disparity=8, step=3, baseline=4.0):
    """A batch of TRAIN_BATCH frame pairs from make_sequence: a camera
    translating along x by ``step`` px a frame over a fronto-parallel
    texture at normalized depth baseline / disparity; the ground truth is
    that translation."""
    import torch

    ls, rs = make_sequence(TRAIN_BATCH + 1, disparity=disparity, step=step, seed=9)
    nchw = lambda a: torch.from_numpy(
        np.ascontiguousarray(a[:, 0].transpose(0, 3, 1, 2))).float().to(dev)
    b = TRAIN_BATCH
    mask = torch.ones((b, 1, H, W), dtype=torch.bool, device=dev)
    depth = baseline / disparity
    gt = torch.zeros((b, 7), device=dev)
    gt[:, 0] = -step * depth / FX          # content moves left: x' = x - t
    gt[:, 6] = 1.0
    K = torch.tensor([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]],
                     device=dev).expand(b, 3, 3).contiguous()
    bl = torch.full((b,), baseline, device=dev)
    return (nchw(ls[:-1]), nchw(ls[1:]), nchw(rs[:-1]), nchw(rs[1:]), mask,
            mask, gt, K, bl)


def phase_train(dev, smi):
    """configuration/train.yaml at full width, batch 8, bf16, in two
    configurations: (a) RAFT frozen and cut off (train.stop_flow_grad set:
    with the file's freeze_flow_steps of 1e18, which is not None, the JAX
    trainer's defaults would keep RAFT's gradients live), (b) RAFT live
    through the lane-wise lookup (freeze_flow_steps 0, lookup lanewise,
    remat by default on the card). Random seeded weights, the flow head
    biased as bench.py does and its kernel damped x0.1, so depth is valid
    and RAFT's gradients also pass through the flow deltas."""
    import copy

    base = train_yaml()
    cfg_a = copy.deepcopy(base)
    cfg_a["train"]["stop_flow_grad"] = True
    cfg_b = copy.deepcopy(base)
    cfg_b["train"]["freeze_flow_steps"] = 0
    cfg_b["model"]["lookup"] = "lanewise"
    sd = train_weights_full(base["model"])
    batch = train_batch_full(dev)
    return {name: train_run(dev, smi, "train", name, cfg, sd, batch, live)
            for name, cfg, live in (("a", cfg_a, False), ("b", cfg_b, True))}


def train_yaml():
    """configuration/train.yaml as the trainer's config (model, train,
    image_shape)."""
    from robust_pose_tpu_torch.utils.config import read_yaml

    y = read_yaml("configuration/train.yaml")
    require(y["train"]["batch_size"] == TRAIN_BATCH
            and tuple(y["image_shape"]) == (H, W), "train.yaml changed")
    return {"model": dict(y["model"]), "image_shape": y["image_shape"],
            "train": dict(y["train"])}


def train_weights_full(model_cfg):
    """Random seeded full-width weights for ``model_cfg``, the flow head
    biased as bench.py does and its kernel damped x0.1, so depth is valid
    and RAFT's gradients also pass through the flow deltas."""
    import torch

    from robust_pose_tpu_torch.models.posenet import PoseNet

    m = PoseNet(dict(model_cfg, image_shape=(H, W)), device="cpu")
    m.reset_parameters(torch.Generator().manual_seed(0))
    fh = m.flow.update["update_block"].flow_head.conv2
    with torch.no_grad():
        fh.weight.mul_(0.1)
        fh.bias.copy_(torch.tensor([-8.0 / (8.0 * model_cfg["iters"]), 0.0]))
    return m.state_dict()


# ---------------------------------------------------------------------------
# phases small_slice, small, checkpoints
# ---------------------------------------------------------------------------

def phase_small(dev, smi):
    """RAFT's small variant at full width: f2f windows (configuration/
    infer_f2f.yaml with small: True; K1 at radius 3 on 128 channels, K2 at
    32/64/96) with success 1.0 and the bf16-vs-f32 gate, then the training
    step (configuration/train.yaml with small: True, batch 8, RAFT live
    through the lane-wise lookup, K4/K5 at radius 3, remat, dropout 0.1)
    with remat_policy "dots" and, for its peak memory beside it,
    "nothing". Returns the launches of the f2f windows and of the "dots"
    steps."""
    f2f = phase_main(dev, smi, small=True)
    cfgs, sd = small_train_configs()
    batch = train_batch_full(dev)
    train = {policy: train_run(dev, smi, "small_train", policy, cfg, sd,
                               batch, True) for policy, cfg in cfgs.items()}
    return f2f, train["dots"]


def small_train_configs():
    """configuration/train.yaml with small: True, RAFT live through the
    lane-wise lookup, remat, dropout 0.1: one config for each remat_policy
    ("dots", "nothing"), and the seeded full-width weights."""
    import copy

    base = train_yaml()
    base["model"].update(small=True, dropout=0.1, remat=True,
                         lookup="lanewise")
    base["train"]["freeze_flow_steps"] = 0
    cfgs = {}
    for policy in ("dots", "nothing"):
        cfgs[policy] = copy.deepcopy(base)
        cfgs[policy]["model"]["remat_policy"] = policy
    return cfgs, train_weights_full(base["model"])


def poison_free_memory(dev):
    """Fill most of the card's free memory with NaN and hand it back to
    the caching allocator, so that a later ``torch.empty`` block holds NaN
    where nothing wrote it."""
    import torch

    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info(dev)
    junk = torch.full((int(free * 0.8) // 4,), float("nan"), device=dev)
    del junk


def phase_small_train_repro(dev, smi, trainers=48, steps=2):
    """``python3 chip_smoke.py small_train``: RAFT small's full-width
    training step (phase small's configurations, weights and batch), for
    each remat_policy ``trainers`` fresh trainers of ``steps`` steps each;
    every other trainer has the allocator's free memory filled with NaN
    before each step (an unwritten element read then shows as NaN). Every
    step runs under ``StepProbe``; a step whose loss or gradient norm is
    not finite is printed with its ``explain``, counted as the reference's
    own where ``reference_nan`` holds (the trainer's later steps are then
    not read), and otherwise fails the phase after all have run."""
    import torch

    from robust_pose_tpu_torch.train.trainer import PoseNetTrainer

    cfgs, sd = small_train_configs()
    batch = train_batch_full(dev)
    faults = []
    for policy, cfg in cfgs.items():
        t0 = time.perf_counter()
        gnorms, losses, ref = [], [], 0
        for n in range(trainers):
            tr = PoseNetTrainer(cfg, device=dev)
            st = tr.init_state(sd)
            probe = StepProbe(tr)
            metrics = []
            for _ in range(steps):
                if n % 2:
                    poison_free_memory(dev)
                st, mt = tr.train_step(st, batch)
                metrics.append(mt)
            probe.remove()
            for i, mt in enumerate(metrics):
                loss, gn = float(mt["train/loss_total"]), float(mt["train/grad_norm"])
                losses.append(loss)
                gnorms.append(gn)
                if np.isfinite(loss) and np.isfinite(gn):
                    continue
                expl = probe.explain(i)
                fault = {"policy": policy, "trainer": n, "poisoned": bool(n % 2),
                         "loss": loss, "grad_norm": gn,
                         "reference_nan": reference_nan(expl, loss, gn), **expl}
                emit({"phase": "small_train_repro", "fault": fault})
                if fault["reference_nan"]:
                    ref += 1
                else:
                    faults.append(fault)
                break
            del tr, st, probe, metrics
            torch.cuda.empty_cache()
        fin = [g for g in gnorms if np.isfinite(g)]
        emit({"phase": "small_train_repro", "policy": policy, "card": smi,
              "trainers": trainers, "steps_each": steps,
              "steps": len(gnorms), "poisoned_steps": (trainers // 2) * steps,
              "reference_nan_steps": ref,
              "other_non_finite": sum(1 for f in faults if f["policy"] == policy),
              "grad_norm": [min(fin), max(fin)] if fin else None,
              "loss": [min(losses), max(losses)],
              "seconds": time.perf_counter() - t0})
    require(not faults, f"small_train_repro: {len(faults)} non-finite steps "
            "that are not the reference's")


def phase_checkpoints(dev, model_cfg, sd, slam, K, frames):
    """Checkpoints on the card, RAFT small at 64x96 in f32:
    (1) save_checkpoint / load_checkpoint_any of the weights of phase
    small_slice: a PoseEstimator built from the loaded bundle tracks the
    same frames to the same poses, bit for bit (the same kernels on the
    same inputs: no atomics on the inference path);
    (2) a training run (small, RAFT live, lane-wise, remat "dots", dropout
    0.1): step 1, save_train_state, step 2; a fresh trainer from
    load_train_state takes step 2 again. Its step, count, loss and
    dropout masks equal the uninterrupted run's; its parameters within
    2 lr everywhere and 1e-3 lr where the gradient is above 1e-3 of its
    leaf's largest (plus 1e-4 of the largest of all leaves), Adam's
    moments within 1e-4 of their leaf's largest (plus 1e-6 of all leaves').
    The bits are printed but not required: the backward of the bilinear
    upsampling (torch's upsample_bilinear2d_backward, in the small
    variant's flow and the TinyUNet heads) adds with atomics, so two runs
    of the same step differ in their last bits on the card (with
    deterministic algorithms torch refuses that backward)."""
    import os
    import tempfile

    import torch

    from robust_pose_tpu_torch.slam.pose_estimator import PoseEstimator
    from robust_pose_tpu_torch.train.trainer import PoseNetTrainer
    from robust_pose_tpu_torch.utils.checkpoints import (
        load_checkpoint_any,
        load_train_state,
        save_checkpoint,
        save_train_state,
    )

    h, w = model_cfg["image_shape"]
    ls, rs, mask = frames
    out = {}
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        save_checkpoint(tmp, sd, {"model": model_cfg})
        poses = []
        for ckpt in ({"state_dict": sd, "config": {"model": model_cfg}},
                     load_checkpoint_any(tmp)):
            est = PoseEstimator(slam, K, 250.0, ckpt, (w, h), device=dev)
            est(ls[0], rs[0], mask)
            p, _ = est.track_window(ls[1:3], rs[1:3], np.stack([mask] * 2))
            poses.append(p.cpu())
        require(same_bits([poses[0]], [poses[1]]),
                "checkpoints: the reloaded estimator's poses differ")
        out["estimator_poses_bit_equal"] = True

        lr = 1e-4
        cfg = {"model": {k: v for k, v in model_cfg.items() if k != "image_shape"},
               "image_shape": [h, w],
               "train": {"learning_rate": lr, "weight_decay": 5e-5,
                         "epsilon": 1e-8, "grad_clip": 1.0, "freeze_flow_steps": 0}}
        cfg["model"].update(lookup="lanewise", remat=True, remat_policy="dots",
                            dropout=0.1, lbgfs_iters=50)
        rng = np.random.default_rng(4)
        b = 2
        img = lambda: rng.uniform(0, 255, (b, 3, h, w)).astype(np.float32)
        gt = np.zeros((b, 7), np.float32)
        gt[:, 6], gt[:, 0] = 1.0, 0.01
        Kb = np.tile(np.float32(K), (b, 1, 1))
        m = np.ones((b, 1, h, w), bool)
        batches = [(img(), img(), img(), img(), m, m, gt, Kb,
                    np.ones((b,), np.float32)) for _ in range(2)]
        tr = PoseNetTrainer(cfg, device=dev)
        st = tr.init_state(sd)
        st, _ = tr.train_step(st, batches[0])
        save_train_state(tmp, st)
        runs = []
        for resumed in (False, True):
            if resumed:
                tr = PoseNetTrainer(cfg, device=dev)
                st = tr.init_state(load_train_state(tmp))
                require(st.step == 1 and st.opt_state.count == 1,
                        "checkpoints: step and count not restored")
            seen = spy_grads(tr)
            masks = []
            undo = replay_dropout(masks)
            try:
                st, mt = tr.train_step(st, batches[1])
            finally:
                undo()
            runs.append({"loss": mt["train/loss_total"].cpu(), "masks": masks,
                         "grads": seen[0], "step": st.step,
                         "count": st.opt_state.count,
                         "params": {k: v.detach().cpu().clone()
                                    for k, v in st.params.items()},
                         "mu": {k: v.cpu() for k, v in st.opt_state.mu.items()},
                         "nu": {k: v.cpu() for k, v in st.opt_state.nu.items()}})
    a, r = runs
    require(a["step"] == r["step"] == 2 and a["count"] == r["count"] == 2,
            "checkpoints: step or count after the resumed step")
    require(len(a["masks"]) == 2 and all(torch.equal(x, y) for x, y in
                                          zip(a["masks"], r["masks"])),
            "checkpoints: the resumed step drew other dropout masks")
    loss_rel = float((a["loss"] - r["loss"]).abs() / a["loss"].abs())
    require(loss_rel <= 1e-5, f"checkpoints: loss differs by {loss_rel}")
    # per leaf, relative to the leaf's own scale plus a floor relative to
    # the largest of all leaves: a leaf whose gradient is rounding noise
    # (a bias that an instance norm cancels) has noise for moments, and
    # Adam moves its elements by ~lr * sign(noise)
    gmax = max(float(g.abs().max()) for g in a["grads"].values() if g is not None)
    mmax = {m: max(float(v.abs().max()) for v in a[m].values()) for m in ("mu", "nu")}
    worst = {"param_over_tol": 0.0, "moment_over_tol": 0.0}
    where = {}
    bits = True
    for k, g in a["grads"].items():
        pa, pr = a["params"][k], r["params"][k]
        bits = bits and torch.equal(pa, pr)
        d = (pa - pr).abs()
        require(float(d.max()) <= 2 * lr, f"checkpoints: parameter {k}")
        if g is not None:
            big = g.abs() > 1e-3 * float(g.abs().max()) + 1e-4 * gmax
            if bool(big.any()):
                ratio = float(d[big].max()) / (1e-3 * lr)
                if ratio > worst["param_over_tol"]:
                    worst["param_over_tol"], where["param"] = ratio, k
        for mom in ("mu", "nu"):
            ma, mr = a[mom][k], r[mom][k]
            tol = 1e-4 * float(ma.abs().max()) + 1e-6 * mmax[mom]
            ratio = float((ma - mr).abs().max()) / tol
            if ratio > worst["moment_over_tol"]:
                worst["moment_over_tol"], where["moment"] = ratio, f"{mom} {k}"
    require(worst["param_over_tol"] <= 1.0 and worst["moment_over_tol"] <= 1.0,
            f"checkpoints: resumed step 2 off the uninterrupted one: {worst} "
            f"at {where}")
    emit({"phase": "checkpoints", "shape": [h, w], **out,
          "resume": {"loss_rel_diff": loss_rel, "params_bit_equal": bits,
                     "worst_error_over_tolerance": worst, "worst_at": where}})


class StepProbe:
    """What a non-finite gradient norm needs explained, recorded for every
    ``train_step`` of a trainer while installed, from the step itself:
    the per-sample loss before the nanmean, the cotangent the pose layer's
    backward received (a hook on the predicted tangent), the pose layer's
    LM iteration counts and done / failure flags (its solve asked for
    ``flags``: the same launch), the stereo flows' pixels whose depth
    derivative baseline / flow_x^2 is not finite (flow_x zero: the
    reference's depth division then gives every RAFT gradient NaN, see
    ``reference_nan``) with the finiteness of the gradient each stereo flow
    received, and the gradients handed to the optimizer. Only references
    to device tensors are kept: no host sync a step. ``explain(i)`` reads
    step i on the host."""

    def __init__(self, tr):
        import torch

        from robust_pose_tpu_torch.solver import gauss_newton as GN
        from robust_pose_tpu_torch.train import trainer as T

        self.steps = []
        self._undo = []
        solve, loss = GN.lm_solve, T.supervised_pose_loss
        step, update = tr.train_step, tr.optimizer.update
        depth = tr.model.disparity_to_depth

        def depth_probed(stereo_flow, baseline):
            rec = self.steps[-1]
            fx = stereo_flow[..., 0].detach().float()
            steep = ~torch.isfinite(baseline[:, None, None] / (fx * fx))
            rec.setdefault("steep_flow_px", []).append(steep.sum())
            if stereo_flow.requires_grad:
                grads = rec.setdefault("stereo_flow_grad_finite", [])
                stereo_flow.register_hook(
                    lambda g: grads.append(torch.isfinite(g).all()))
            return depth(stereo_flow, baseline)

        def solve_flags(*a, **kw):
            if kw.get("flags"):
                return solve(*a, **kw)
            *out, niter, done, failed = solve(*a, **kw, flags=True)
            self.steps[-1]["solve"] = (niter, done, failed)
            return (*out, niter)

        def loss_hooked(pose_tan, gt):
            rec = self.steps[-1]
            if pose_tan.requires_grad:
                pose_tan.register_hook(
                    lambda g: rec.__setitem__("cotangent", g.detach().clone()))
            out = loss(pose_tan, gt)
            rec["loss"] = out.detach().sum(-1)
            rec["tangent"] = pose_tan.detach()
            return out

        def update_spy(params, grads, opt_state):
            self.steps[-1]["grads"] = grads
            return update(params, grads, opt_state)

        def step_probed(state, batch):
            self.steps.append({})
            return step(state, batch)

        GN.lm_solve, T.supervised_pose_loss = solve_flags, loss_hooked
        tr.train_step, tr.optimizer.update = step_probed, update_spy
        tr.model.disparity_to_depth = depth_probed
        self._undo = [lambda: setattr(GN, "lm_solve", solve),
                      lambda: setattr(T, "supervised_pose_loss", loss),
                      lambda: setattr(tr, "train_step", step),
                      lambda: setattr(tr.optimizer, "update", update),
                      lambda: delattr(tr.model, "disparity_to_depth")]

    def remove(self):
        for undo in self._undo:
            undo()

    def explain(self, i):
        import torch

        rec = self.steps[i]
        bad = [k for k, g in rec.get("grads", {}).items()
               if g is not None and not bool(torch.isfinite(g).all())]
        host = lambda t: None if t is None else t.float().cpu().tolist()
        niter, done, failed = rec.get("solve", (None, None, None))
        cot = rec.get("cotangent")
        return {"step": i, "non_finite_leaves": len(bad),
                "leaves": bad[:24],
                "non_finite_outside_raft": [k for k in bad
                                            if not k.startswith("flow.")],
                "steep_flow_px": [int(n) for n in rec.get("steep_flow_px", [])],
                "stereo_flow_grad_finite": [bool(f) for f in
                                            rec.get("stereo_flow_grad_finite", [])],
                "loss_per_sample": host(rec.get("loss")),
                "tangent_finite": host(torch.isfinite(rec["tangent"]).all(-1))
                if "tangent" in rec else None,
                "lm_iters": host(niter), "done": host(done),
                "failed": host(failed),
                "cotangent_finite": None if cot is None
                else host(torch.isfinite(cot).all(-1)),
                "cotangent_absmax": None if cot is None
                else host(cot.abs().amax(-1))}


def reference_nan(expl, loss, gnorm):
    """True when a step's non-finite gradient norm is the reference's own
    (tests/test_torch_port_train_nonfinite.py: the JAX package's trainer
    gives the same non-finite leaves): some stereo flow x is zero (its
    depth derivative baseline / flow_x^2 is not finite), so the depth
    division's backward gives 0 * inf = NaN under the validity mask and
    every RAFT gradient (flow.*) is NaN, while the loss and every other
    gradient stay finite. The update then makes every parameter NaN, in
    the reference as here, so nothing is asserted of later steps."""
    return (np.isfinite(loss) and not np.isfinite(gnorm)
            and expl["non_finite_leaves"] > 0
            and not expl["non_finite_outside_raft"]
            and sum(expl["steep_flow_px"]) > 0)


def check_steps(probe, metrics, what):
    """Every step's loss and gradient norm finite, except from a step
    whose non-finite gradient is the reference's own (``reference_nan``)
    on. Returns that step's ``explain`` (None if every step was finite)."""
    for i, mt in enumerate(metrics):
        loss, gn = float(mt["train/loss_total"]), float(mt["train/grad_norm"])
        if np.isfinite(loss) and np.isfinite(gn):
            continue
        expl = probe.explain(i)
        require(reference_nan(expl, loss, gn),
                f"{what}: step {i}: loss {loss}, grad norm {gn}; "
                + json.dumps(expl))
        return expl
    return None


TRAIN_STEP_S = {}             # train_run's seconds a step of this run, by phase


def train_run(dev, smi, phase, name, cfg, sd, batch, live):
    """One training configuration at full width: 1 warm-up and TRAIN_TIMED
    timed steps with the launch counters set to 0 just before and read just
    after, then one step under torch.profiler. ``live``: RAFT's gradients
    flow (through the lane-wise lookup), else RAFT is frozen and cut off.
    A non-finite loss or gradient norm fails with ``StepProbe.explain`` of
    the step. Returns the launch counts of the timed steps."""
    import torch

    from robust_pose_tpu_torch.train.trainer import PoseNetTrainer

    iters = cfg["model"]["iters"]
    tr = PoseNetTrainer(cfg, device=dev)
    st = tr.init_state(sd)
    probe = StepProbe(tr)
    flow0 = {k: v.detach().clone() for k, v in st.params.items()
             if k.startswith("flow.")}
    st, warm = tr.train_step(st, batch)                     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    t0 = time.perf_counter()
    metrics = []
    for _ in range(TRAIN_TIMED):
        st, mt = tr.train_step(st, batch)
        metrics.append(mt)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    probe.remove()
    TRAIN_STEP_S[f"{phase} {name}"] = dt / TRAIN_TIMED
    loss = [float(mt["train/loss_total"]) for mt in metrics]
    gnorm = [float(mt["train/grad_norm"]) for mt in metrics]
    it = tr.last_solver_iters.cpu()
    moved = [k for k, v in flow0.items()
             if not torch.equal(st.params[k].detach(), v)]
    per_step = {k: v / TRAIN_TIMED for k, v in launches.items()}
    what = f"{phase} {name}"
    ref_nan = check_steps(probe, [warm] + metrics, what)
    del probe
    finite = [g for g in gnorm if np.isfinite(g)]
    require(min(finite, default=1.0) > 0, f"{what}: zero gradient norm {gnorm}")
    one_solve_a_call(launches, what)
    # the norms' backward recomputes through the statistics entry: only
    # where RAFT's gradients are live
    require(per_step["lm_solve"] == 1 and per_step["instance_norm"] > 0
            and (per_step["instance_norm_stats"] > 0) == live,
            f"{what}: launches {launches}")
    if not live:
        require(per_step["lanewise_lookup"] == 0
                and per_step["lanewise_lookup_bwd"] == 0
                and per_step["corr_window_lookup"] == iters,
                f"{what}: launches {launches}")
        require(not moved, f"{what}: RAFT parameters moved: {moved[:3]}")
    else:
        # one launch a 4-level lookup and one a backward; remat runs
        # each GRU iteration's lookup again in the backward pass
        require(per_step["lanewise_lookup_bwd"] == iters
                and per_step["lanewise_lookup"] >= iters
                and per_step["corr_window_lookup"] == 0,
                f"{what}: launches {launches}")
        require(len(moved) == len(flow0),
                f"{what}: {len(flow0) - len(moved)} RAFT parameters still")
    emit({"phase": phase, "config": name, "card": smi,
          "shape": [H, W], "batch": TRAIN_BATCH,
          "model": {k: tr.model.config.get(k, True) for k in
                    ("iters", "lbgfs_iters", "stop_flow_grad", "remat",
                     "remat_policy", "small", "dropout", "lookup",
                     "mixed_precision", "use_weights")},
          "timed_steps": TRAIN_TIMED, "step_s": dt / TRAIN_TIMED,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "loss_total": loss, "grad_norm": gnorm, "reference_nan": ref_nan,
          "launches_per_step": per_step,
          "lm_iters": {"mean": float(it.float().mean()), "max": int(it.max()),
                       "min": int(it.min())},
          "raft_params_moved": len(moved), "raft_params": len(flow0)})
    prof = profile_run(lambda: tr.train_step(st, batch), "train_step.")
    if live and "group_ms" in prof:
        # the lane-wise lookup's share of the profiled step; before the
        # pyramid kernels (96 K4 and 48 K5 launches a step, a memset
        # before each K5) K4 took 4.71 ms and K5 9.44 ms without its
        # memsets in train b (NVIDIA H100 80GB HBM3, 700 W)
        prof["lanewise_in_step_ms"] = {
            "K4": prof["group_ms"].get("lanewise_lookup (K4)", 0.0),
            "K5": prof["group_ms"].get("lanewise_lookup_bwd (K5)", 0.0),
            "memsets": prof["group_ms"].get("memsets", 0.0),
            "earlier": {"K4": 4.71, "K5": 9.44} if phase == "train" else None}
    if not live:
        prof["k1_in_step"] = k1_in_window(prof)
    emit({"phase": phase + "_profile", "config": name, **prof})
    del tr, st, flow0
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phases 8 to 10
# ---------------------------------------------------------------------------

F2M_POOL_FRAMES = 4           # pool pre-sized to 4 frames, as bench.py does
F2M_WINDOW_K1 = (12, 12)      # K1 launches: one a 4-level lookup, 12
                              # iterations, precompute (batch T) and frame
F2M_WINDOW_K7 = (12, 12)      # K7 (lookup "grouped"): one launch a 4-level
                              # lookup, 12 iterations, precompute and frame
F2M_WINDOW_K2 = (15, 15)      # K2: one fnet pass in the precompute, one a frame


def f2m_pool_case(dev, model_cfg, sd, K, ls, rs, mask):
    """The pool's overflow redo, ``average_pts`` and ``upscale`` on the
    card: f2m at 64x96 in f32 with ``dist_thr`` 0.05, ``average_pts`` on,
    surfel ``upscale`` 2 and the default bucket of 2 frames in a pool of 8,
    the first frame and one window of 4 frames (nearly every frame appends,
    so the window overflows its bucket and is re-run from its carries at a
    grown one), on the card (K1) and on the CPU (plain versions). Success
    flags, the re-run count, the pool's counters, bucket, ``active`` and
    ``t_created``, the winner slots of every rendering that reaches an
    output (the window's first reference and each frame's in the run that
    is kept) and the carried model-frame mask equal bit for bit; poses
    within 1e-4. The renderings of the runs that the overflow discards may
    differ at a pixel boundary (<= 0.5 % of the pixels, the phase's mask
    tolerance; printed)."""
    import torch

    from robust_pose_tpu_torch.slam import surfel_map as SM
    from robust_pose_tpu_torch.slam.pose_estimator import PoseEstimator

    h, w = model_cfg["image_shape"]
    slam = {"frame2frame": False, "lbgfs_iters": 5, "conf_weighing": True,
            "depth_clipping": [1, 250], "dist_thr": 0.05, "average_pts": True,
            "upscale": 2, "map_capacity": 8 * h * w}
    t = 4
    winner_frame = SM._winner_frame
    res = {}
    for where in ("cuda", "cpu"):
        slots = []

        def spy(state, slot_img, *a):
            slots.append(slot_img.cpu())
            return winner_frame(state, slot_img, *a)

        est = PoseEstimator(slam, K, 250.0, {"state_dict": sd,
                                            "config": {"model": model_cfg}},
                            (w, h), device=dev if where == "cuda" else "cpu")
        est(ls[0], rs[0], mask)
        bucket0 = est.scene.cfg.capacity
        steps = [0]
        step = est._f2m_step

        def counted(*a):
            steps[0] += 1
            return step(*a)

        est._f2m_step = counted
        SM._winner_frame = spy
        try:
            zero_launch_counts()
            p, s = est.track_window(ls[1:1 + t], rs[1:1 + t], np.stack([mask] * t))
            launches = launch_counts()
            launches["solve_pose_calls"] = SOLVE_CALLS[0]
        finally:
            SM._winner_frame = winner_frame
        st = est.scene.state
        res[where] = {"poses": p.cpu(), "succ": s.cpu(), "slots": slots,
                      "reruns": steps[0] // t - 1, "rest": steps[0] % t,
                      "counters": [est.scene.n_active, int(st.hi),
                                   int(st.n_dropped), bucket0,
                                   est.scene.cfg.capacity],
                      "active": st.active.cpu(), "t_created": st.t_created.cpu(),
                      "mask": est._model_frame.mask.cpu(), "launches": launches}
        del est
    c, p = res["cuda"], res["cpu"]
    dist = tangent_distance(c["poses"], p["poses"])
    require(c["rest"] == 0 and p["rest"] == 0, "f2m_slice pool: partial frame loop")
    require(bool(p["succ"].any()), "f2m_slice pool: every frame failed")
    require(torch.equal(c["succ"], p["succ"]), "f2m_slice pool: success flags")
    require(dist <= 1e-4, f"f2m_slice pool: pose tangent distance {dist}")
    require(c["reruns"] == p["reruns"] and p["reruns"] >= 1,
            f"f2m_slice pool: re-runs {c['reruns']} (card), {p['reruns']} (CPU)")
    require(c["counters"] == p["counters"] and p["counters"][4] > p["counters"][3],
            f"f2m_slice pool: counters {c['counters']} vs {p['counters']}")
    require(torch.equal(c["active"], p["active"])
            and torch.equal(c["t_created"], p["t_created"]),
            "f2m_slice pool: active slots differ")
    # renderings: the window's first reference, then one a frame in every
    # run of the frame loop; the runs cut short by the overflow are
    # discarded (their renderings reach no output), the last run's are kept
    slot_diff = [int((a != b).sum()) for a, b in zip(c["slots"], p["slots"])]
    require(len(c["slots"]) == len(p["slots"]) == 1 + t * (1 + c["reruns"]),
            f"f2m_slice pool: {len(c['slots'])} and {len(p['slots'])} renderings")
    kept = [slot_diff[0]] + slot_diff[-t:]
    require(not any(kept) and max(slot_diff) <= 0.005 * h * w,
            f"f2m_slice pool: winner slots differ at {slot_diff} pixels")
    require(torch.equal(c["mask"], p["mask"]), "f2m_slice pool: model-frame mask")
    lc = c["launches"]
    # one launch a 4-level lookup: the precompute's GRU iterations, then
    # each frame's, in every run of the frame loop
    require(lc["corr_window_lookup"]
            == model_cfg["iters"] * (1 + t * (1 + c["reruns"]))
            and lc["lm_solve"] == lc["solve_pose_calls"] == t * (1 + c["reruns"])
            and lc["normal_eq"] == 0
            and not any(v for k, v in p["launches"].items()
                        if k != "solve_pose_calls"), f"f2m_slice pool: launches {lc}")
    return {"slam": slam, "window": t, "pose_tangent_dist": dist,
            "success": c["succ"].tolist(), "window_loop_reruns": c["reruns"],
            "n_active_hi_dropped_bucket0_bucket": c["counters"],
            "renderings": len(c["slots"]), "winner_slot_flips": slot_diff,
            "launches_cuda": lc}


def phase_f2m_slice(dev):
    """f2m at 64x96 in f32, the same weights and frames on the card
    (kernels) and on the CPU (plain versions), with ``lookup`` "onthefly"
    (K1; "auto" would take "xla" on the CPU) and with ``grouped``: the
    first frame, one per-frame step, then one window of 3 frames. Success
    flags equal, pose tangent distance <= 1e-4, n_active within 0.5 %, and
    the rendered model-frame masks (the step's reference, the window's
    carried next reference) equal at >= 99.5 % of pixels: a surfel whose
    projection sits on a pixel boundary can fall on either side on the two
    devices (flips are printed). Then ``f2m_pool_case``."""
    import torch

    from robust_pose_tpu_torch.slam.pose_estimator import PoseEstimator

    h, w = 64, 96
    model_cfg = {"image_shape": (h, w), "iters": 2, "lbgfs_iters": 5,
                 "use_weights": True, "mixed_precision": False, "unet_levels": 1}
    slam = {"frame2frame": False, "lbgfs_iters": 5, "conf_weighing": True,
            "depth_clipping": [1, 250], "dist_thr": 0.05, "average_pts": False,
            "map_capacity": 8 * h * w}
    K = np.array([[100.0, 0, w / 2], [0, 100.0, h / 2], [0, 0, 1.0]])
    sd = small_state_dict(model_cfg, seed=11)
    ls, rs = make_sequence(5, disparity=3, step=2, seed=5, h=h, w=w)
    mask = np.ones((1, h, w, 1), bool)
    report = {}
    for lookup in ("onthefly", "grouped"):
        res = {}
        for where in ("cuda", "cpu"):
            est = PoseEstimator(slam, K, 250.0, {
                "state_dict": sd, "config": {"model": dict(model_cfg, lookup=lookup)}},
                (w, h), device=dev if where == "cuda" else "cpu")
            zero_launch_counts()
            est(ls[0], rs[0], mask)
            pose, _, _, _ = est(ls[1], rs[1], mask)
            step = (pose.cpu(), est.success.cpu().reshape(1),
                    est.get_last_frame().mask.cpu())
            p, s = est.track_window(ls[2:5], rs[2:5], np.stack([mask] * 3))
            res[where] = {"poses": torch.cat([step[0][None], p.cpu()]),
                          "succ": torch.cat([step[1], s.cpu()]),
                          "masks": [step[2], est._model_frame.mask.cpu()],
                          "n_active": est.scene.n_active,
                          "niter": est.last_solver_iters.cpu().tolist(),
                          "launches": launch_counts(), "solves": SOLVE_CALLS[0]}
            del est
        c, p = res["cuda"], res["cpu"]
        dist = tangent_distance(c["poses"], p["poses"])
        flips = [int((a != b).sum()) for a, b in zip(c["masks"], p["masks"])]
        agree = min(1.0 - f / (h * w) for f in flips)
        lc = c["launches"]
        lookup_k = "grouped_lookup" if lookup == "grouped" else "corr_window_lookup"
        other_k = "corr_window_lookup" if lookup == "grouped" else "grouped_lookup"
        require(bool(p["succ"].any()), f"f2m_slice {lookup}: every frame failed")
        require(torch.equal(c["succ"], p["succ"]), f"f2m_slice {lookup}: success flags")
        require(dist <= 1e-4, f"f2m_slice {lookup}: pose tangent distance {dist}")
        require(abs(c["n_active"] - p["n_active"]) <= 0.005 * p["n_active"],
                f"f2m_slice {lookup}: n_active {c['n_active']} vs {p['n_active']}")
        require(agree >= 0.995, f"f2m_slice {lookup}: model-frame masks {flips}")
        require(lc[lookup_k] > 0 and lc[other_k] == 0 and lc["normal_eq"] == 0
                and lc["lm_solve"] == c["solves"] > 0
                and lc["instance_norm"] > 0 and lc["instance_norm_stats"] == 0,
                f"f2m_slice {lookup}: {lc}")
        require(not any(p["launches"].values()), f"f2m_slice {lookup}: CPU launches")
        report[lookup] = {"pose_tangent_dist": dist, "success": c["succ"].tolist(),
                          "n_active_cuda": c["n_active"], "n_active_cpu": p["n_active"],
                          "mask_flips": flips, "launches_cuda": lc,
                          "niter_cuda": c["niter"], "niter_cpu": p["niter"]}
    pool = f2m_pool_case(dev, dict(model_cfg, lookup="onthefly"), sd, K, ls, rs,
                         mask)
    emit({"phase": "f2m_slice", "shape": [h, w], "tol": {
        "pose": 1e-4, "n_active_rel": 0.005, "mask_agreement": 0.995}, **report,
        "pool_redo": pool})


def f2m_slam():
    """configuration/infer_scared.yaml's SLAM settings, read from the file,
    with the pool pre-sized to F2M_POOL_FRAMES frames (map_capacity =
    initial_bucket) and the segsort winner, as bench.py's f2m cell does."""
    from robust_pose_tpu_torch.utils.config import read_yaml

    y = read_yaml("configuration/infer_scared.yaml")["slam"]
    require(y["frame2frame"] is False and y["lbgfs_iters"] == 100
            and y["conf_weighing"] is True and y["average_pts"] is False
            and y["dist_thr"] == 0.05, f"infer_scared.yaml changed: {y}")
    slam = {k: y[k] for k in ("frame2frame", "lbgfs_iters", "conf_weighing",
                              "depth_clipping", "dist_thr", "average_pts")}
    cap = F2M_POOL_FRAMES * H * W
    slam.update(map_capacity=cap, initial_bucket=cap, winner="segsort")
    return slam


def f2m_reruns(launches, lookup_key, n_windows, per_window=F2M_WINDOW_K1):
    """Frame loops re-run after a pool overflow (a window's loop runs again
    from its carries when compaction frees room), from the lookup launches:
    each window runs one precompute, each loop T per-frame lookups
    (``per_window``: the launches of the precompute and of one frame)."""
    pre, per = per_window
    loops, rest = divmod(launches[lookup_key] - pre * n_windows, per * T_WINDOW)
    require(rest == 0 and loops >= n_windows, f"f2m: {lookup_key} launches {launches}")
    return loops - n_windows


def phase_f2m(dev, smi):
    """f2m at full width (512x640, T = 8, infer_scared.yaml: 100 LM
    iterations, weight heads, bf16), random seeded weights with bench.py's
    flow head, bench.py's synthetic sequence: first frame, 2 warm-up and 4
    timed windows with the launch counters set to 0 just before and read
    just after; then one timed window with lookup "grouped" (K7) after one
    warm-up window, against a default-lookup estimator on the same frames;
    then one window under the profiler (f2m_profile)."""
    import torch

    slam = f2m_slam()
    est, sd = production_estimator(dev, True, slam=slam)
    ls, rs = make_sequence(1, seed=11)
    mask1 = np.ones((1, H, W, 1), bool)
    est(ls[0], rs[0], mask1)
    masks = torch.ones((T_WINDOW, 1, H, W, 1), dtype=torch.bool, device=dev)
    windows = []
    for i in range(N_TIMED + 2):
        l, r = make_sequence(T_WINDOW, seed=12 + i)
        windows.append((torch.from_numpy(l).to(dev), torch.from_numpy(r).to(dev)))
    for i in (-1, -2):                                     # warm-up
        est.track_window(windows[i][0], windows[i][1], masks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    t0 = time.perf_counter()
    succs, iters, poses = [], [], None
    for i in range(N_TIMED):
        poses, succ = est.track_window(windows[i][0], windows[i][1], masks)
        succs.append(succ)
        iters.append(est.last_solver_iters)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    reruns = f2m_reruns(launches, "corr_window_lookup", N_TIMED)
    pre, per = F2M_WINDOW_K2
    require(launches["instance_norm"]
            == pre * N_TIMED + per * T_WINDOW * (N_TIMED + reruns)
            and launches["instance_norm_stats"] == 0,
            f"f2m: instance norms {launches}")
    one_solve_a_call(launches, "f2m")
    require(launches["lm_solve"] == T_WINDOW * (N_TIMED + reruns)
            and not any(launches[k] for k in ("lanewise_lookup", "lanewise_lookup_bwd",
                                              "pixel_lookup", "grouped_lookup")),
            f"f2m: launches {launches}")
    require(bool(torch.isfinite(poses).all()), "f2m: non-finite poses")
    succ = torch.cat(succs)
    it = torch.cat(iters).cpu()
    st = est.scene.state
    F2M_FPS["f2m"] = N_TIMED * T_WINDOW / dt
    emit({"phase": "f2m", "card": smi, "shape": [H, W], "window": T_WINDOW,
          "slam": slam, "timed_windows": N_TIMED, "fps": N_TIMED * T_WINDOW / dt,
          "seconds": dt, "success_rate": float(succ.float().mean()),
          "lm_iters": {"mean": float(it.float().mean()), "max": int(it.max()),
                       "min": int(it.min())},
          "n_active": est.scene.n_active, "n_dropped": int(st.n_dropped),
          "hi": int(st.hi), "bucket_capacity": est.scene.cfg.capacity,
          "window_loop_reruns": reruns,
          "launches_per_window": {k: v / N_TIMED for k, v in launches.items() if v},
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})

    # lookup "grouped" (K7) beside the default lookup, on the same frames
    ests = {lk: production_estimator(dev, True, state_dict=sd, slam=slam,
                                     lookup=lk)[0] for lk in ("grouped", None)}
    for e in ests.values():
        e(ls[0], rs[0], mask1)
        e.track_window(windows[-1][0], windows[-1][1], masks)
    ref_poses, _ = ests[None].track_window(windows[0][0], windows[0][1], masks)
    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    g_poses, g_succ = ests["grouped"].track_window(windows[0][0], windows[0][1], masks)
    torch.cuda.synchronize()
    dt_g = time.perf_counter() - t0
    g_launches = launch_counts()
    g_reruns = f2m_reruns(g_launches, "grouped_lookup", 1, F2M_WINDOW_K7)
    one_solve_a_call(g_launches, "f2m grouped")
    require(g_launches["corr_window_lookup"] == 0 and g_launches["pixel_lookup"] == 0
            and g_launches["lm_solve"] == T_WINDOW * (1 + g_reruns),
            f"f2m grouped: launches {g_launches}")
    dist = tangent_distance(g_poses, ref_poses)
    # the two lookups read the same bf16 features through volumes pooled
    # in another order; the tolerance of the f2f bf16-vs-f32 check
    require(dist < 2e-2, f"f2m grouped: pose distance to the default lookup {dist}")
    emit({"phase": "f2m_grouped", "card": smi, "fps": T_WINDOW / dt_g,
          "seconds": dt_g, "success_rate": float(g_succ.float().mean()),
          "window_loop_reruns": g_reruns,
          "launches": {k: v for k, v in g_launches.items() if v},
          "pose_dist_to_default_lookup": dist, "tol": 2e-2})
    del ests
    torch.cuda.empty_cache()

    prof = profile_run(lambda: est.track_window(windows[1][0], windows[1][1], masks),
                       ("f2m_", "fuse_render"))
    # before the redesign (432 launches a window): 52.3 ms of kernels;
    # before the one-launch LM solve f2m_track.solve took 321.1-461.8 ms of
    # device time for 18.3-18.6 ms of kernels, 12,884 launches over 8
    # frames (NVIDIA H100 80GB HBM3, 700 W)
    emit({"phase": "f2m_profile", "window": T_WINDOW, **prof,
          "k1_in_window": k1_in_window(prof, {"k1_ms": 52.3}),
          "solve_span": solve_span(prof, "f2m_track.solve", T_WINDOW, {
              "device_ms": [321.1, 461.8], "kernel_ms": [18.3, 18.6],
              "launches": 12884})})
    return launches, g_launches


# ---------------------------------------------------------------------------
# phases parity, roofline and tools
# ---------------------------------------------------------------------------

PARITY_FRAMES = 5             # the JAX harness's defaults: 5 frames,
PARITY_ITERS = 4              # 4 GRU iterations, 384x512


def captured(fn, *args):
    """``fn(*args)`` with its stdout captured (the port's tools print
    tables); returns (result, what it printed)."""
    import contextlib
    import io

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        res = fn(*args)
    return res, printed.getvalue()


def phase_parity(dev, smi):
    """The port's golden-parity harness (robust_pose_tpu_torch.scripts.
    verify_parity) against the reference network: ``--selftest`` at
    384x512, 5 frames, 4 GRU iterations, the port on the card (f32, K1,
    K2 and K3's LM solve, each launched at least once a frame), the
    reference network on the CPU, recording its outputs (``--record``);
    every row must PASS. Then ``--golden`` on that recording from a second
    process: the same rows (the objective row, which needs the live
    reference network, aside), bit for bit in value."""
    import os
    import tempfile

    from robust_pose_tpu_torch.scripts import verify_parity as vp

    t0 = time.perf_counter()
    root = tempfile.mkdtemp()
    golden = os.path.join(root, "golden.npz")
    args = vp.build_parser().parse_args(
        ["--selftest", "--frames", str(PARITY_FRAMES), "--iters",
         str(PARITY_ITERS), "--record", golden])
    zero_launch_counts()
    (rows, ok), printed = captured(vp.run, args)
    launches = launch_counts()
    print(printed, end="", flush=True)
    require(ok and all(r[3] for r in rows), f"parity: rows {rows}")
    tracked = PARITY_FRAMES - 1
    require(launches["corr_window_lookup"] >= PARITY_FRAMES
            and launches["instance_norm"] >= PARITY_FRAMES
            and launches["lm_solve"] >= tracked,
            f"parity: the port's kernels did not run each frame: {launches}")
    out_json = os.path.join(root, "golden_rows.json")
    res = subprocess.run(
        [sys.executable, "-m", "robust_pose_tpu_torch.scripts.verify_parity",
         "--posenet", args.posenet, "--golden", golden, "--frames",
         str(PARITY_FRAMES), "--iters", str(PARITY_ITERS), "--json", out_json],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    print(res.stdout, end="", flush=True)
    require(res.returncode == 0, f"parity --golden: exit {res.returncode}: "
            f"{res.stdout[-2000:]} {res.stderr[-2000:]}")
    with open(out_json) as f:
        golden_rows = json.load(f)["rows"]
    first = {n: v for n, v, _, _ in rows}
    same = {n: first.get(n) == v for n, v, _, _ in golden_rows}
    left_out = sorted(set(first) - {n for n, *_ in golden_rows})
    require(all(same.values()) and left_out == ["GN obj excess over LBFGS (rel)"],
            f"parity: --golden rows differ from the live run's: {same}, "
            f"left out {left_out}")
    emit({"phase": "parity", "card": smi, "shape": [384, 512],
          "frames": PARITY_FRAMES, "iters": PARITY_ITERS,
          "rows": [{"name": n, "value": v, "tol": t, "pass": bool(p)}
                   for n, v, t, p in rows],
          "golden_rows": [{"name": n, "value": v, "tol": t, "pass": p}
                          for n, v, t, p in golden_rows],
          "golden_bit_equal": same,
          "launches": {k: v for k, v in launches.items() if v},
          "seconds": time.perf_counter() - t0})


def registered(fn):
    """What ``fn()`` adds to a counter: {op: (flops, bytes)}; the launch
    counters left as they were."""
    saved = launch_counts()
    with costs.count() as c:
        fn()
    restore_launch_counts(saved)
    return {k: (v[0], v[1]) for k, v in c.by_op.items()}


def kernel_costs(dev):
    """Each kernel wrapper's registered FLOPs and bytes at phase kernels'
    shapes (K1: an f2f window's B = 16, noisy, bf16; K2's statistics entry
    and norm: the three fnet shapes at B = 16; K3: one build and the B = 8, 20-iteration solve;
    K4/K5: the training step's noisy inputs; K6/K7: the f2m step's B = 1)
    against the numbers its bound is computed from there."""
    import torch

    from robust_pose_tpu_torch.ops import corr_pixel as KP
    from robust_pose_tpu_torch.ops import instance_norm as K2
    from robust_pose_tpu_torch.ops import normal_eq as K3
    from robust_pose_tpu_torch.solver.gauss_newton import SolverConfig

    out = {}

    def check(name, got, ops, nbytes):
        out[name] = {"registered": list(got.get(name, ())),
                     "bound_from": [ops, nbytes]}
        require(got.get(name) == (ops, nbytes),
                f"costs {name}: registered {got} against {(ops, nbytes)}")

    f1, levels, coords = corr_inputs(dev, 2 * T_WINDOW, "noisy", torch.bfloat16)
    kernel = corr_entries(f1, levels, coords)[0]
    _, _, nbytes, ops = corr_bound(f1, levels, coords)
    check("corr_window_lookup", registered(kernel), ops, nbytes)
    del f1, levels, coords, kernel
    g = torch.Generator(device=dev).manual_seed(2)
    for h, w, c in ((H // 2, W // 2, 64), (H // 4, W // 4, 96), (H // 8, W // 8, 128)):
        x = torch.randn(2 * T_WINDOW, h, w, c, generator=g, device=dev).bfloat16()
        ops, nbytes, _ = costs.instance_norm_stats(x)
        got = registered(lambda: K2.instance_norm_stats(x))
        out.setdefault("instance_norm_stats", []).append(
            {"shape": list(x.shape), "registered": list(got["instance_norm_stats"])})
        require(got["instance_norm_stats"] == (ops, nbytes),
                f"costs instance_norm_stats {tuple(x.shape)}: {got}")
        # the norm registers the bytes its design moves (x read twice);
        # its row's bound takes the floor (x read once) from the same formula
        ops, nbytes, _ = costs.instance_norm(x)
        floor = costs.instance_norm(x, x_reads=1)
        got = registered(lambda: K2.instance_norm(x, relu=True))
        out.setdefault("instance_norm", []).append(
            {"shape": list(x.shape), "registered": list(got["instance_norm"]),
             "bound_from": [floor[0], floor[1]]})
        require(got == {"instance_norm": (ops, nbytes)}
                and nbytes - floor[1] == x.numel() * x.element_size(),
                f"costs instance_norm {tuple(x.shape)}: {got}")
    planes, kvec, lw, g = solver_inputs(dev, T_WINDOW)
    from robust_pose_tpu_torch import se3
    pose = se3.exp(0.01 * torch.randn(T_WINDOW, 6, generator=g, device=dev))
    ops, nbytes, _ = costs.normal_equations(T_WINDOW, H, W)
    check("normal_eq", registered(
        lambda: K3.normal_equations(pose, planes, kvec, lw, H, W)), ops, nbytes)
    cfg = SolverConfig(iters=20)
    niter = K3.lm_solve(planes, kvec, lw, H, W, cfg)[1]
    ops, nbytes, _ = costs.lm_solve(niter, H, W)
    check("lm_solve", registered(lambda: K3.lm_solve(planes, kvec, lw, H, W, cfg)),
          ops, nbytes)
    out["lm_solve"]["builds"] = int((1 + niter).sum())
    del planes, kvec, lw
    pyramid, coords, grads = lanewise_inputs(dev, "noisy")
    fwd, _, bwd, _ = lanewise_entries(pyramid, coords, grads)
    ops, nbytes, _ = costs.lanewise_fwd(pyramid, coords)
    check("lanewise_lookup", registered(fwd), ops, nbytes)
    ops, nbytes, _ = costs.lanewise_bwd(pyramid, coords)
    check("lanewise_lookup_bwd", registered(bwd), ops, nbytes)
    del pyramid, coords, grads, fwd, bwd
    pyramid, coords = pixel_inputs(dev, 1, H // 8, W // 8, torch.bfloat16)
    n = pyramid[0].shape[1]
    ops, nbytes, _ = costs.pixel_lookup(
        [v.reshape(n, *v.shape[2:]) for v in pyramid], coords.reshape(n, 2))
    check("pixel_lookup", registered(lambda: KP.pixel_lookup_pyramid(pyramid, coords)),
          ops, nbytes)
    check("grouped_lookup", registered(
        lambda: KP.grouped_lookup_pyramid(pyramid, coords)), ops, nbytes)
    torch.cuda.empty_cache()
    return out


def phase_roofline(dev, smi):
    """The port's roofline (robust_pose_tpu_torch.scripts.roofline) on the
    card: f2f (window 8), f2m (window 4, 100 LM iterations) and training
    step (batch 8, remat, RAFT live through K4/K5; per sample) rows, each
    from one counted and one timed run; MFU at most 100 %. A second
    counted run of each path counts the same FLOPs; its per-op and
    per-span rows sum to its totals. Then each kernel wrapper's
    registered work at phase kernels' shapes against the numbers its
    bound is computed from (kernel_costs)."""
    from robust_pose_tpu_torch.scripts import roofline

    t0 = time.perf_counter()
    rows, printed = captured(roofline.main, ["--windows", "4", "--by-op", "12",
                                             "--train"])
    print(printed, end="", flush=True)
    require([r["path"] for r in rows] == ["f2f_window", "f2m_window_iters100",
                                          f"train_step_batch{roofline.TRAIN_BATCH}"],
            f"roofline: rows {rows}")
    require(all(0.0 < r["mfu_pct"] <= 100.0 and np.isfinite(r["hbm_util_pct"])
                and r["device"] is not None for r in rows), f"roofline: {rows}")
    again = {}
    for r, (path, window) in zip(rows, (("f2f", T_WINDOW), ("f2m", roofline.F2M_WINDOW))):
        c = roofline.count_window(path, dev, window)
        again[path] = {"flops": c.flops, "bytes": c.bytes,
                       "flops_equal": c.flops == r["flops"],
                       "bytes_equal": c.bytes == r["bytes"]}
        require(c.flops == r["flops"], f"roofline {path}: a second counted run "
                f"counts {c.flops} FLOPs against {r['flops']}")
        for rows_of in (c.by_op, c.by_span, c.by_dtype):
            require(sum(v[0] for v in rows_of.values()) == c.flops
                    and sum(v[1] for v in rows_of.values()) == c.bytes,
                    f"roofline {path}: rows do not sum to the totals")
        del c
    emit({"phase": "roofline", "card": smi, "rows": rows, "second_count": again,
          "kernel_costs": kernel_costs(dev), "seconds": time.perf_counter() - t0})


def phase_tools(dev, smi):
    """The port's profile tools and the exact_render A/B on the card:
    profile_trace on f2f (2 windows of 8: its kernel groups' ms sum to the
    busy ms within 1 %), profile_stages (2 windows), profile_f2m (1 window
    of 8, a 4-frame pool), profile_encoder at B = 1 and 16, and
    ab_exact_render at full width over 4 f2m frames (two windows of 2)."""
    from robust_pose_tpu_torch.scripts import (
        ab_exact_render,
        profile_encoder,
        profile_f2m,
        profile_stages,
        profile_trace,
    )

    t0 = time.perf_counter()
    seconds = {}
    trace, _ = captured(profile_trace.main, ["--path", "f2f", "--windows", "2",
                                         "--top", "15"])
    seconds["profile_trace"] = time.perf_counter() - t0
    require(abs(trace["group_ms_sum_over_busy"] - 1.0) <= 0.01,
            f"profile_trace: group ms / busy ms {trace['group_ms_sum_over_busy']}")
    stages, _ = captured(profile_stages.main, ["--iters", "2"])
    require(set(stages["stages_per_frame"]) == {
        f"infer_window.{s}" for s in profile_stages.STAGES},
        f"profile_stages: {sorted(stages['stages_per_frame'])}")
    seconds["profile_stages"] = time.perf_counter() - t0 - sum(seconds.values())
    f2m, _ = captured(profile_f2m.main, ["--iters", "1", "--frames", "4"])
    require({"f2m_precompute", "f2m_track.solve", "fuse_render"}
            <= set(f2m["stages_per_frame"]),
            f"profile_f2m: {sorted(f2m['stages_per_frame'])}")
    seconds["profile_f2m"] = time.perf_counter() - t0 - sum(seconds.values())
    enc, _ = captured(profile_encoder.main, ["--batches", "1", "16", "--iters", "5"])
    require(all(np.isfinite(r["device_ms"]) and r["device_ms"] > 0
                for r in enc["rows"]), f"profile_encoder: {enc}")
    k2 = [r for r in enc["rows"] if r["variant"] == "instance_k2"]
    require(all(r["k2_device_ms"] > 0 for r in k2)
            and all(r["k2_device_ms"] == 0 for r in enc["rows"]
                    if r["variant"] != "instance_k2"),
            f"profile_encoder: K2 ran where it should not, or not where it should")
    seconds["profile_encoder"] = time.perf_counter() - t0 - sum(seconds.values())
    (ab, vec_on, vec_off), _ = captured(ab_exact_render.main, ["--windows", "2",
                                                               "--window", "2"])
    require(ab["frames"] == 4 and np.isfinite(vec_on).all()
            and np.isfinite(vec_off).all() and ab["fps_exact_on"] > 0
            and ab["fps_exact_off"] > 0, f"ab_exact_render: {ab}")
    seconds["ab_exact_render"] = time.perf_counter() - t0 - sum(seconds.values())
    emit({"phase": "tools", "card": smi, "profile_trace": trace,
          "profile_stages": stages, "profile_f2m": f2m, "profile_encoder": enc,
          "ab_exact_render": ab, "seconds": seconds})


# ---------------------------------------------------------------------------
# phase bench
# ---------------------------------------------------------------------------

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "f2m_fps_iters100",
              "f2f_success_rate", "f2m_success_rate", "f2f_lm_iters",
              "f2m_lm_iters", "f2f_fps_noearlyexit", "f2f_fps_diagnostics",
              "f2f_fps_diagnostics_nofetch", "d2h_MBps", "f2m_fps_noearlyexit",
              "f2m_fps_iters20_noearlyexit"}
BENCH_RATES = ("value", "f2m_fps_iters100", "f2f_fps_noearlyexit",
               "f2f_fps_diagnostics", "f2f_fps_diagnostics_nofetch",
               "f2m_fps_noearlyexit", "f2m_fps_iters20_noearlyexit", "d2h_MBps")
# bench.main's windows: f2f 6 timed, then 4 with diagnostics fetched, 4
# without the fetch, 4 with early exit off; f2m 4, then 2 and 2 with early
# exit off (100 and 20 LM iterations); each run after 2 warm-up windows
BENCH_F2F_WINDOWS = 6 + 4 + 4 + 4 + 4 * 2
BENCH_F2M_WINDOWS = 4 + 2 + 2 + 3 * 2


def phase_bench(dev, smi):
    """The port's bench (robust_pose_tpu_torch.scripts.bench.main) in this
    process with bench.py's defaults, its stdout captured, the launch
    counters set to 0 just before and read just after: one JSON line with
    bench.py's keys, FPS finite and positive, success rates in [0, 1],
    realized LM iterations within the caps 20 and 100, and every window's
    launches (12 K1, 15 K2 and 1 LM solve an f2f window; an f2m window a
    precompute and its loops). Then the line beside phase main's and phase
    f2m's FPS of this call; no timing is gated."""
    import contextlib
    import io

    import torch

    from robust_pose_tpu_torch.scripts import bench

    printed, windows = io.StringIO(), []
    undo = count_windows(windows)
    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            res = bench.main([])
    finally:
        undo()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    lines = [ln for ln in printed.getvalue().splitlines() if ln.strip()]
    require(len(lines) == 1, f"bench: printed {lines}")
    out = json.loads(lines[0])
    require(out == res and set(out) == BENCH_KEYS,
            f"bench: keys {sorted(set(out) ^ BENCH_KEYS)}")
    require(all(np.isfinite(out[k]) and out[k] > 0 for k in BENCH_RATES),
            f"bench: rates {out}")
    require(all(0.0 <= out[k] <= 1.0 for k in ("f2f_success_rate",
                                                "f2m_success_rate")),
            f"bench: success rates {out}")
    require(1 <= out["f2f_lm_iters"]["min"] <= out["f2f_lm_iters"]["max"] <= 20
            and 1 <= out["f2m_lm_iters"]["min"] <= out["f2m_lm_iters"]["max"] <= 100,
            f"bench: LM iterations {out['f2f_lm_iters']}, {out['f2m_lm_iters']}")
    f2f = [w for w in windows if w["frame2frame"]]
    f2m = [w for w in windows if not w["frame2frame"]]
    require(len(f2f) == BENCH_F2F_WINDOWS and len(f2m) == BENCH_F2M_WINDOWS,
            f"bench: {len(f2f)} f2f and {len(f2m)} f2m windows")
    others = ("lanewise_lookup", "lanewise_lookup_bwd", "pixel_lookup",
              "grouped_lookup", "normal_eq", "instance_norm_stats")
    for w in f2f:
        require(w["corr_window_lookup"] == 12 and w["instance_norm"] == 15
                and w["lm_solve"] == 1 and not any(w[k] for k in others),
                f"bench: f2f window launches {w}")
    reruns = 0
    pre, per = F2M_WINDOW_K2
    for w in f2m:
        r = f2m_reruns(w, "corr_window_lookup", 1)
        require(w["instance_norm"] == pre + per * T_WINDOW * (1 + r)
                and w["lm_solve"] == T_WINDOW * (1 + r)
                and not any(w[k] for k in others),
                f"bench: f2m window launches {w}")
        reruns += r
    one_solve_a_call(launches, "bench")
    emit({"phase": "bench", "card": smi, "bench": out,
          "main_fps": MAIN_FPS.get("main"), "f2m_fps": F2M_FPS.get("f2m"),
          "seconds": seconds, "windows": {"f2f": len(f2f), "f2m": len(f2m)},
          "launches_per_f2f_window": {k: f2f[0][k] for k in (
              "corr_window_lookup", "instance_norm", "lm_solve")},
          "f2m_window_loop_reruns": reruns, "launches": launches})
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase cli
# ---------------------------------------------------------------------------

DECODE_H, DECODE_W = 2 * H, 2 * W   # StereoMIS-sized decode: ResizeStereo 0.5
CLI_F2F_FRAMES = 1 + 4 * T_WINDOW   # the first frame and 4 windows
CLI_F2M_FRAMES = 1 + 2 * T_WINDOW
PREPROC_TOL = 1e-3                  # bilinear paths, card vs CPU, 0-255 scale


class SmoothMaps:
    """A conventional-mode rectifier's fields for ``DevicePreproc``: a
    smooth displacement of the identity grid at 512x640 (amplitude 0.75
    px: the nearest remap moves some pixels by one), built in numpy since
    ``stereoRectify`` needs cv2."""
    mode = "conventional"

    def __init__(self, phase=(0.0, 1.3)):
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
        self.maps, self.cal = {}, {}
        for side, ph in zip("lr", phase):
            self.maps[side + "map1"] = (xs + 0.75 * np.sin(ys / 23.0 + ph)).astype(np.float32)
            self.maps[side + "map2"] = (ys + 0.75 * np.cos(xs / 31.0 + ph)).astype(np.float32)


class PseudoShift:
    """A pseudo-mode rectifier's fields: the right camera's principal point
    (0.5, -0.25) px from the left's, a bilinear shift of the right image."""
    mode = "pseudo"
    maps = {}
    cal = {"lkmat": PRODUCTION_K, "rkmat": PRODUCTION_K + np.array(
        [[0, 0, -0.5], [0, 0, 0.25], [0, 0, 0]])}


def decode_frames(n, seed):
    """``n`` vertically stacked stereo frames at decode scale (2048 x 1280
    RGB uint8, top = left) from make_sequence: disparity 16 px and 6 px a
    frame, so 8 and 3 at 512x640, as phase main's frames."""
    ls, rs = make_sequence(n, disparity=16, step=6, seed=seed,
                           h=DECODE_H, w=DECODE_W)
    return [np.concatenate([l[0], r[0]], axis=0) for l, r in zip(ls, rs)]


def preproc_check(dev):
    """DevicePreproc on the card against the CPU from 1024 x 1280 uint8
    halves with specular patches, with maps (nearest remap) and with the
    pseudo shift (bilinear): masks and the nearest-remapped images bit for
    bit, the bilinear outputs within PREPROC_TOL; then the time of one
    call on the card (numpy halves in, as the CLI calls it)."""
    import torch

    from robust_pose_tpu_torch.data.device_preproc import DevicePreproc

    frame = decode_frames(1, seed=21)[0].copy()
    h, w = DECODE_H // 16, DECODE_W // 16                  # specularities
    frame[5 * h:6 * h, 8 * w:10 * w] = 255
    frame[DECODE_H + 11 * h:DECODE_H + 12 * h, 2 * w:3 * w] = 255
    limg, rimg = frame[:DECODE_H], frame[DECODE_H:]
    out = {}
    for name, rect in (("maps", SmoothMaps()), ("pseudo", PseudoShift())):
        res = {where: DevicePreproc((W, H), rect, device=where)(limg, rimg)
               for where in ("cuda", "cpu")}
        card = [t.cpu() for t in res["cuda"]]
        cpu = res["cpu"]
        err = [float((a.double() - b.double()).abs().max()) for a, b in
               zip(card[:2], cpu[:2])]
        require(card[0].shape == (3, H, W) and card[2].shape == (1, H, W)
                and card[2].dtype == torch.bool, f"preproc {name}: shapes")
        require(torch.equal(card[2], cpu[2]), f"preproc {name}: masks differ")
        require(0 < float(cpu[2].float().mean()) < 1,
                f"preproc {name}: the mask masks nothing or everything")
        if name == "maps":
            require(err == [0.0, 0.0], f"preproc maps: nearest remap err {err}")
        require(max(err) <= PREPROC_TOL, f"preproc {name}: err {err}")
        pre = DevicePreproc((W, H), rect, device=dev)
        call = lambda: pre(limg, rimg)
        dev_ms, n = device_time_ms(call)
        out[name] = {"max_abs_err": err, "mask_true_share": float(cpu[2].float().mean()),
                     "device_ms": dev_ms, "device_ops": n,
                     "ms": cuda_time_ms(call, reps=10)}
    return out


def memory_video(root, frames, rectify):
    """The port's StereoVideoDataset over ``frames`` held in memory (its
    ``_frames`` and ``_frame_count`` overridden), with ``root``'s
    groundtruth.txt as its poses."""
    import os

    from robust_pose_tpu_torch.data.video_dataset import StereoVideoDataset

    class MemoryVideo(StereoVideoDataset):
        def _frame_count(self):
            return len(frames)

        def _frames(self):
            yield from frames

    path = os.path.join(root, "sequence.mp4")
    open(path, "wb").close()
    return MemoryVideo(path, os.path.join(root, "groundtruth.txt"),
                       img_size=(W, H), rectify=rectify)


def write_groundtruth(root, n):
    """groundtruth.txt of the sequence: the camera moves 3 px of the
    512x640 image a frame at depth PRODUCTION_BF / 8, along x; the line
    stamped k holds frame k + 4's pose (the CLI evaluates at offset -4);
    n lines, as the video dataset stops where its poses end."""
    import os

    dx = 3 * (PRODUCTION_BF / 8) / FX / 1000.0            # metres a frame
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        for k in range(1, n + 1):
            f.write(f"{k} {(k + 3) * dx!r} 0.0 0.0 0.0 0.0 0.0 1.0\n")


def count_windows(record, last=None):
    """Record the launches of every PoseEstimator.track_window call (the
    counters' deltas) and whether it tracked frame to frame; keep the
    last call's outputs in ``last`` where given. Returns the undo."""
    from robust_pose_tpu_torch.slam.pose_estimator import PoseEstimator as PE

    inner = PE.track_window

    def counted(self, *a, **kw):
        before = launch_counts()
        out = inner(self, *a, **kw)
        after = launch_counts()
        record.append({"frame2frame": self.frame2frame,
                       **{k: after[k] - before[k] for k in after}})
        if last is not None:
            last[:] = [out]
        return out

    PE.track_window = counted
    return lambda: setattr(PE, "track_window", inner)


def cli_run(dev, cfg_path, n_frames, rectify, seed, extra=(), last=None):
    """The port's CLI ``run`` (robust_pose_tpu_torch.scripts.
    infer_trajectory) on ``cfg_path`` as read, ``--window 8
    --device-preproc --device cuda`` and the flags ``extra``, over
    ``n_frames`` decode-scale frames from memory, weights through
    save_checkpoint / load_checkpoint_any: one warm-up pass, then the timed
    pass with the launch counters set to 0 just before and read just
    after; the last window's outputs kept in ``last`` where given. Returns
    what it measured."""
    import contextlib
    import io
    import os
    import re
    import tempfile

    import torch

    from robust_pose_tpu_torch.scripts import infer_trajectory as cli
    from robust_pose_tpu_torch.utils.checkpoints import save_checkpoint
    from robust_pose_tpu_torch.utils.config import read_yaml
    from robust_pose_tpu_torch.utils.evaluate import evaluate
    from robust_pose_tpu_torch.utils.profiling import StageTimer
    from robust_pose_tpu_torch.utils.trajectory import read_freiburg

    config = read_yaml(cfg_path)
    frames = decode_frames(n_frames, seed)
    calib = {"intrinsics": {"left": PRODUCTION_K}, "bf": PRODUCTION_BF,
             "img_size": (W, H)}
    with tempfile.TemporaryDirectory() as root:
        model_cfg = production_model_cfg()
        save_checkpoint(os.path.join(root, "ckpt"),
                        production_weights(dev, model_cfg),
                        {"model": model_cfg})
        write_groundtruth(root, n_frames)
        for attempt in ("warm-up", "timed"):
            args = cli.build_parser().parse_args([
                root, "--checkpoint", os.path.join(root, "ckpt"), "--outpath",
                os.path.join(root, attempt), "--window", str(T_WINDOW),
                "--device-preproc", "--device", "cuda", *extra])
            dataset = memory_video(root, frames, rectify)
            timer, windows, printed = StageTimer(), [], io.StringIO()
            undo = count_windows(windows, last)
            torch.cuda.synchronize()
            zero_launch_counts()
            try:
                with contextlib.redirect_stdout(printed):
                    cli.run(args, config, dataset, calib, timer=timer)
            finally:
                undo()
            launches = launch_counts()
        poses, stamps = read_freiburg(os.path.join(args.outpath, "trajectory.freiburg"),
                                      ret_stamps=True)
        ate, rpe_t, rpe_r, pairs, *_ = evaluate(
            os.path.join(root, "groundtruth.txt"),
            os.path.join(args.outpath, "trajectory.freiburg"), offset=-4)
        plys = sorted(f for f in os.listdir(args.outpath) if f.endswith(".ply"))
    text = printed.getvalue()
    surfels = re.findall(r"^surfels: .*$", text, re.M)
    loop_s = timer.totals["loop"]
    out = dict(frames=n_frames, fps=n_frames / loop_s, loop_s=loop_s,
               stage_ms=timer.summary(), trajectory_lines=len(poses),
               ate_rmse_mm=ate, rpe_trans_mm=rpe_t,
               rpe_rot_deg=float(np.rad2deg(rpe_r)), compared_pairs=len(pairs),
               printed=[ln for ln in text.splitlines()
                        if ln.startswith(("ATE/", "surfels: "))],
               surfel_summary=surfels[0] if surfels else None, plys=plys,
               launches=launches, windows=windows)
    require(len(poses) == 1 + n_frames and stamps[0] == 0
            and list(stamps[1:]) == list(range(1, n_frames + 1)),
            f"cli {cfg_path}: {len(poses)} trajectory lines, stamps {list(stamps)}")
    require(bool(np.isfinite(poses).all()), f"cli {cfg_path}: non-finite poses")
    require(all(np.isfinite([ate, rpe_t, rpe_r])) and len(pairs) > 1,
            f"cli {cfg_path}: ATE {ate}, RPE {rpe_t} {rpe_r} over {len(pairs)}")
    require(text.rstrip().endswith("finished") and "ATE/RMSE" in text,
            f"cli {cfg_path}: printed {text[-300:]}")
    return out


CLI_ROW_FRAMES = 25                 # the scenario rows' sequence
CLI_ROWS = ({"scenario": "breathing", "start": "0", "end": "17"},
            {"scenario": "tool", "start": "8", "end": "25"})


def memory_pngs(ls, rs):
    """The port's StereoDataset (preprocessed PNGs) over make_sequence
    frames held in memory (its ``__getitem__`` overridden: no cv2 on the
    card's machine), so that the CLI's start and stop apply."""
    from robust_pose_tpu_torch.data.stereo_dataset import StereoDataset

    class MemoryPNG(StereoDataset):
        def __init__(self):
            self.imgs = [f"{i + 1:06d}l.png" for i in range(len(ls))]

        def __getitem__(self, item):
            return (ls[item, 0].transpose(2, 0, 1).astype(np.float32),
                    rs[item, 0].transpose(2, 0, 1).astype(np.float32),
                    np.ones((1, H, W), bool), self.imgs[item][:6])

    return MemoryPNG()


def scenario_rows(dev):
    """The scenario CLI's row loop (benchmark_scenarios.run_rows) over
    CLI_ROWS on the card, each row ``infer_trajectory.run`` on
    infer_f2f.yaml with ``--window 8`` over make_sequence frames served
    from memory; then each row's range again through a direct ``run``: the
    trajectory files equal byte for byte, every window 12 K1, 15 K2 and 1
    LM solve."""
    import contextlib
    import io
    import os
    import tempfile

    from robust_pose_tpu_torch.scripts import benchmark_scenarios as bs
    from robust_pose_tpu_torch.scripts import infer_trajectory as cli
    from robust_pose_tpu_torch.utils.checkpoints import save_checkpoint
    from robust_pose_tpu_torch.utils.config import read_yaml

    config = read_yaml("configuration/infer_f2f.yaml")
    ls, rs = make_sequence(CLI_ROW_FRAMES, seed=51)
    calib = {"intrinsics": {"left": PRODUCTION_K}, "bf": PRODUCTION_BF}
    infer = lambda a, c: cli.run(a, c, memory_pngs(ls, rs), calib)
    with tempfile.TemporaryDirectory() as root:
        model_cfg = production_model_cfg()
        ckpt = os.path.join(root, "ckpt")
        save_checkpoint(ckpt, production_weights(dev, model_cfg), {"model": model_cfg})
        write_groundtruth(root, CLI_ROW_FRAMES)
        flags = ["--checkpoint", ckpt, "--window", str(T_WINDOW), "--device", "cuda"]
        args = bs.build_parser("scenarios").parse_args(
            [root, "--outpath", os.path.join(root, "rows"), *flags])
        windows, printed = [], io.StringIO()
        undo = count_windows(windows)
        zero_launch_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(printed):
                bs.run_rows(args, config, CLI_ROWS, infer)
        finally:
            undo()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        one_solve_a_call(launches, "cli rows")
        same = []
        for i, row in enumerate(CLI_ROWS):
            direct = cli.build_parser().parse_args(
                [root, "--outpath", os.path.join(root, f"direct{i}"), "--start",
                 row["start"], "--stop", row["end"], *flags])
            with contextlib.redirect_stdout(io.StringIO()):
                infer(direct, dict(config))
            files = [open(os.path.join(d, "trajectory.freiburg"), "rb").read()
                     for d in (os.path.join(root, "rows", str(i)), direct.outpath)]
            n_lines = files[0].count(b"\n")
            want = 1 + int(row["end"]) - int(row["start"])
            require(files[0] == files[1] and n_lines == want,
                    f"cli rows: row {i} ({n_lines} lines, {want} wanted) differs "
                    "from a direct run")
            same.append(n_lines)
    heads = [ln for ln in printed.getvalue().splitlines() if " -> " in ln]
    require(heads == [f"{r['start']} -> {r['end']} : {r['scenario']}" for r in CLI_ROWS]
            and printed.getvalue().count("finished") == len(CLI_ROWS),
            f"cli rows: printed {heads}")
    for w in windows:
        require(w["corr_window_lookup"] == 12 and w["instance_norm"] == 15
                and w["instance_norm_stats"] == 0
                and w["lm_solve"] == 1 and w["normal_eq"] == 0,
                f"cli rows: window launches {w}")
    return {"rows": len(CLI_ROWS), "trajectory_lines": same,
            "windows": len(windows), "seconds": seconds,
            "fps": sum(int(r["end"]) - int(r["start"]) for r in CLI_ROWS) / seconds,
            "launches": {k: v for k, v in launches.items() if v}}


class RecordingViewer:
    """Stands in for ``Viewer2D`` (no matplotlib on the card's machine):
    keeps each frame's index and whether its image, depth, confidences
    and flow have the documented shapes and finite values."""
    calls = []

    def __init__(self, outpath=None, blocking=False):
        pass

    def __call__(self, frame, weights, flow, idx=0):
        from robust_pose_tpu_torch.viewer.viewer2d import to_host

        arrays = {"img": (frame.img, 3), "depth": (frame.depth, 1),
                  "conf1": (weights[0], 1), "conf2": (weights[1], 1),
                  "flow": (flow, 2)}
        ok = {}
        for k, (x, c) in arrays.items():
            x = to_host(x)
            ok[k] = x.shape == (1, H, W, c) and bool(np.isfinite(x).all())
        RecordingViewer.calls.append({"idx": idx, **ok})


def viewer_runs(dev):
    """The CLI with ``--viewer 2d`` (RecordingViewer in Viewer2D's place)
    on infer_f2f.yaml as phase cli's f2f run: diagnostics mode, the maps
    read back once a window. Every frame but the first reaches the viewer
    with finite maps of the documented shapes; then the device time of one
    window's read-back of the maps. (``--log`` takes the same diagnostics
    path but logs to wandb, which needs `wandb.init` and the network.)"""
    import torch

    from robust_pose_tpu_torch.viewer import viewer2d

    inner = viewer2d.Viewer2D
    viewer2d.Viewer2D = RecordingViewer
    RecordingViewer.calls = []
    last = []
    try:
        shown = cli_run(dev, "configuration/infer_f2f.yaml", CLI_F2F_FRAMES,
                        SmoothMaps(), seed=31, extra=["--viewer", "2d"], last=last)
    finally:
        viewer2d.Viewer2D = inner
    calls = RecordingViewer.calls
    frames = list(range(1, CLI_F2F_FRAMES))
    require([c["idx"] for c in calls] == frames * 2
            and all(all(v for k, v in c.items() if k != "idx") for c in calls),
            f"cli viewer: {len(calls)} frames shown, "
            f"{[c for c in calls if not all(c.values())][:3]}")
    diag = last[0][2]
    require(sorted(diag) == ["conf1", "conf2", "depth", "flow"]
            and all(v.dtype == torch.float16 for v in diag.values()),
            "cli viewer: the window's maps")
    readback = lambda: {k: v.cpu().float() for k, v in diag.items()}
    dev_ms, n_ops = device_time_ms(readback)
    for w in shown["windows"]:
        require(w["corr_window_lookup"] == 12 and w["instance_norm"] == 15
                and w["instance_norm_stats"] == 0
                and w["lm_solve"] == 1 and w["normal_eq"] == 0,
                f"cli viewer: window launches {w}")
    keep = ("fps", "loop_s", "stage_ms", "launches", "ate_rmse_mm")
    return {"viewer_2d": {**{k: shown[k] for k in keep}, "frames_shown": len(calls) // 2},
            "diag_readback": {"bytes": sum(v.numel() * 2 for v in diag.values()),
                              "device_ms": dev_ms, "device_ops": n_ops,
                              "ms": cuda_time_ms(readback, reps=10)}}


def phase_cli(dev, smi):
    """The port's trajectory-inference CLI at full width: DevicePreproc
    card against CPU; ``run`` on infer_f2f.yaml (CLI_F2F_FRAMES frames:
    K1, K2 and the LM solve counted a window) and on infer_scared.yaml
    (CLI_F2M_FRAMES frames, its own pool size), each beside phase main's
    FPS of this run; then the scenario CLI's row loop (scenario_rows) and
    the CLI with a viewer (viewer_runs)."""
    import torch

    t0 = time.perf_counter()
    pre = preproc_check(dev)
    f2f = cli_run(dev, "configuration/infer_f2f.yaml", CLI_F2F_FRAMES,
                  SmoothMaps(), seed=31)
    n_win = (CLI_F2F_FRAMES - 1) // T_WINDOW
    lc = f2f["launches"]
    require(len(f2f["windows"]) == n_win, f"cli f2f: {len(f2f['windows'])} windows")
    for w in f2f["windows"]:
        require(w["corr_window_lookup"] == 12 and w["instance_norm"] == 15
                and w["instance_norm_stats"] == 0
                and w["lm_solve"] == 1 and w["normal_eq"] == 0,
                f"cli f2f: window launches {w}")
    one_solve_a_call(lc, "cli f2f")
    require(lc["lm_solve"] == n_win, f"cli f2f: launches {lc}")
    per_window = {k: f2f["windows"][0][k] for k in (
        "corr_window_lookup", "instance_norm", "lm_solve")}
    emit({"phase": "cli", "part": "preproc", "card": smi,
          "decode": [DECODE_H, DECODE_W], "out": [H, W], "tol": PREPROC_TOL,
          **pre})
    emit({"phase": "cli", "part": "f2f", "card": smi, "shape": [H, W],
          "config": "configuration/infer_f2f.yaml", "window": T_WINDOW,
          "launches_per_window": per_window,
          "main_fps": MAIN_FPS.get("main"),
          **{k: v for k, v in f2f.items() if k != "windows"}})
    torch.cuda.empty_cache()

    f2m = cli_run(dev, "configuration/infer_scared.yaml", CLI_F2M_FRAMES,
                  PseudoShift(), seed=41)
    reruns = sum(f2m_reruns(w, "corr_window_lookup", 1) for w in f2m["windows"])
    require(f2m["surfel_summary"] is not None
            and f2m["plys"] == ["all_map.ply", "stable_map.ply"],
            f"cli f2m: summary {f2m['surfel_summary']}, plys {f2m['plys']}")
    one_solve_a_call(f2m["launches"], "cli f2m")
    emit({"phase": "cli", "part": "f2m", "card": smi, "shape": [H, W],
          "config": "configuration/infer_scared.yaml", "window": T_WINDOW,
          "window_loop_reruns": reruns, "main_fps": MAIN_FPS.get("main"),
          "seconds": time.perf_counter() - t0,
          **{k: v for k, v in f2m.items() if k != "windows"}})
    torch.cuda.empty_cache()

    emit({"phase": "cli", "part": "scenario_rows", "card": smi, "shape": [H, W],
          "config": "configuration/infer_f2f.yaml", "window": T_WINDOW,
          "row_list": CLI_ROWS, **scenario_rows(dev)})
    torch.cuda.empty_cache()
    emit({"phase": "cli", "part": "viewer", "card": smi, "shape": [H, W],
          "config": "configuration/infer_f2f.yaml", "window": T_WINDOW,
          "frames": CLI_F2F_FRAMES, "cli_f2f_fps": f2f["fps"],
          "main_fps": MAIN_FPS.get("main"), **viewer_runs(dev)})
    torch.cuda.empty_cache()
    return per_window


# ---------------------------------------------------------------------------
# phases 15 and 16
# ---------------------------------------------------------------------------

OPS_TAIL_TOL = 1e-5           # bilinear, conv and lookup outputs, card vs CPU
RUN_FLOW_TOL = 1e-3           # px: RAFT's flow, card (K1) vs CPU (plain)


def phase_ops_tail(dev):
    """The small ops outside the main paths on the card against the CPU at
    64x96, f32, TF32 off: ops/image (Sobel gradients, batched dot product,
    identity), ops/geometry.reproject, the three warps, ops/interpolation,
    models/raft.lookup_corr_gather and PoseNet.run_flow (with flow2depth
    on it). Nearest samples, medians, validity masks and the identity bit
    for bit; bilinear, conv and lookup outputs within OPS_TAIL_TOL;
    reproject within OPS_TAIL_TOL (its bits reported); RAFT's flow within
    RUN_FLOW_TOL px."""
    import torch

    from robust_pose_tpu_torch.models import raft
    from robust_pose_tpu_torch.models.posenet import PoseNet
    from robust_pose_tpu_torch.ops import geometry, image, interpolation, warp

    h, w = 64, 96
    rng = np.random.default_rng(17)
    f32 = lambda *shape: torch.from_numpy(
        rng.uniform(0.0, 1.0, shape).astype(np.float32))
    x = f32(2, h, w, 3)
    x[:, :6, :6] = 0.0                         # validity takes both values
    nx = (f32(2, h, w, 2) > 0.5).float()
    flow = 12.0 * f32(2, h, w, 2) - 6.0
    holes = f32(2, h, w, 2)
    holes[f32(2, h, w, 2) < 0.2] = float("nan")
    depth = 0.1 + f32(2, 1, h, w)
    K = torch.tensor([[100.5, 0.0, 47.25], [0.0, 99.75, 31.5], [0.0, 0.0, 1.0]])
    grid = torch.meshgrid(torch.arange(w // 8.0), torch.arange(h // 8.0),
                          indexing="xy")
    coords8 = torch.stack(grid, -1)[None] + 6.0 * f32(2, h // 8, w // 8, 2) - 3.0
    fm = [f32(2, h // 8, w // 8, 64) for _ in range(2)]
    cases = {
        "image_gradient": (image.image_gradient, (x.permute(0, 3, 1, 2),), "tol"),
        "batched_dot_product": (image.batched_dot_product,
                                (f32(2, h * w, 3), f32(2, h * w, 3)), "tol"),
        "reproject": (lambda d, k: geometry.reproject(
            d, k, geometry.create_img_coords(h, w, device=d.device)), (depth, K), "tol"),
        "warp_bilinear_nearest": (warp.warp_bilinear_nearest, (x, nx, flow),
                                  "tol,bits,bits,bits"),
        "remap_from_flow": (warp.remap_from_flow, (x, flow), "tol,bits"),
        "remap_from_flow_nearest": (warp.remap_from_flow_nearest, (x, flow),
                                    "bits,bits"),
        "sparse_img_interpolate": (interpolation.sparse_img_interpolate,
                                   (holes,), "tol"),
        "median_filter_2d": (lambda a: interpolation.median_filter_2d(a, 5), (x,), "bits"),
        "sparse_median_interpolate": (interpolation.sparse_median_interpolate,
                                      (holes,), "bits"),
        # an even window: the midpoint of the middle two taps
        "median_filter_2d_k4": (lambda a: interpolation.median_filter_2d(a, 4),
                                (x,), "bits"),
        "sparse_median_interpolate_k4": (
            lambda a: interpolation.sparse_median_interpolate(a, 4), (holes,), "bits"),
        "lookup_corr_gather": (lambda a, b, c: raft.lookup_corr_gather(
            raft.build_corr_pyramid(a, b), c), (*fm, coords8), "tol"),
    }
    out = {}
    for name, (fn, args, how) in cases.items():
        cpu = fn(*args)
        card = fn(*(a.to(dev) for a in args))
        cpu = cpu if isinstance(cpu, tuple) else (cpu,)
        card = card if isinstance(card, tuple) else (card,)
        res = []
        for c, g, kind in zip(cpu, card, how.split(",")):
            g = g.cpu()
            bits = torch.equal(c, g)
            err = float((c.double() - g.double()).abs().max())
            require(bits if kind == "bits" else err <= OPS_TAIL_TOL,
                    f"ops_tail {name}: card vs CPU {err} ({kind})")
            res.append({"kind": kind, "max_abs_err": err, "bits_equal": bits})
        out[name] = res
    eye = image.beye(3, 4, device=dev)
    require(torch.equal(eye.cpu(), image.beye(3, 4)), "ops_tail: beye")

    cfg = {"image_shape": (h, w), "iters": 2, "unet_levels": 1,
           "mixed_precision": False, "lookup": "onthefly"}
    sd = small_state_dict(cfg, seed=19)
    ls, rs = make_sequence(1, disparity=3, step=2, seed=7, h=h, w=w)
    i1, i2 = (torch.from_numpy(a[:, 0]).float() for a in (ls, rs))
    flows = {}
    for where in ("cpu", dev):
        m = PoseNet(cfg, device=where)
        m.load_state_dict(sd)
        zero_launch_counts()
        with torch.no_grad():
            fl, hidden, context = m.run_flow(i1.to(where), i2.to(where))
            d, valid, f2d = m.flow2depth(i1.to(where), i2.to(where),
                                         torch.ones(1, device=where))
        require(torch.equal(f2d, fl) and torch.equal(
            d, PoseNet.disparity_to_depth(fl, torch.ones(1, device=where))[0]),
            f"ops_tail: flow2depth is not run_flow on {where}")
        flows[str(where)] = (fl.cpu(), hidden.cpu(), launch_counts()["corr_window_lookup"])
    (fc, hc, kc), (fg, hg, kg) = flows["cpu"], flows[str(dev)]
    err = float((fc - fg).abs().max())
    # K1: one launch a lookup, iters lookups in run_flow and in flow2depth
    require(err <= RUN_FLOW_TOL and kc == 0 and kg == 2 * cfg["iters"],
            f"ops_tail run_flow: flow error {err} px, K1 launches {kc}, {kg}")
    out["run_flow"] = [{"kind": "tol", "max_abs_err": err,
                        "hidden_max_abs_err": float((hc - hg).abs().max()),
                        "k1_launches_cuda": kg}]
    emit({"phase": "ops_tail", "shape": [h, w], "tol": OPS_TAIL_TOL,
          "run_flow_tol_px": RUN_FLOW_TOL, "cases": out})


TRAIN_CLI_STEPS = 4           # train.epochs 3: the loop stops past its count
TRAIN_CLI_SAMPLES = 40        # data.train.samples a sequence (2000 in the file)
TRAIN_CLI_VAL = 20            # data.val.samples (80 in the file), 2 batches of 10
TRAIN_CLI_VAL_FREQ = 2        # validations after steps 1 and 3
TRAIN_CLI_BF = 800.0          # baseline x focal: depth 100 mm at 8 px disparity
TRAIN_CLI_FRAMES = (48, 48, 24)


TRAIN_CLI_BENCH = {}          # phase train_cli's bench_train_step (as is) of this run


def train_cli_config(steps):
    """configuration/train.yaml as phase train_cli runs it: ``steps``
    steps, TRAIN_CLI_SAMPLES training samples a sequence, TRAIN_CLI_VAL
    validation samples."""
    import copy

    from robust_pose_tpu_torch.utils.config import read_yaml

    y = read_yaml("configuration/train.yaml")
    require(y["train"]["batch_size"] == TRAIN_BATCH and y["val"]["batch_size"] == 10
            and tuple(y["image_shape"]) == (H, W)
            and y["train"]["freeze_flow_steps"] == 10 ** 18, "train.yaml changed")
    cfg = copy.deepcopy(y)
    cfg["train"]["epochs"] = steps - 1
    cfg["data"]["train"]["samples"] = TRAIN_CLI_SAMPLES
    cfg["data"]["val"]["samples"] = TRAIN_CLI_VAL
    return cfg


def write_train_cli_sequences(root):
    for i, n in enumerate(TRAIN_CLI_FRAMES):
        write_pose_sequence(f"{root}/seq{i}", n)


def train_cli_data(root, cfg):
    """Phase train_cli's (training, validation) datasets over the
    sequence folders under ``root`` (write_train_cli_sequences), the
    frames made from their seeds."""
    from robust_pose_tpu_torch.data.train_datasets import ConcatDataset

    data = []
    for i, n in enumerate(TRAIN_CLI_FRAMES):
        split = cfg["data"]["train" if i < 2 else "val"]
        frames = make_sequence(n, disparity=8, step=3, seed=50 + i)
        data.append(memory_pose_dataset(f"{root}/seq{i}", frames, split,
                                        np.random.default_rng(1234 + i)))
    data = (ConcatDataset(data[:2]), ConcatDataset(data[2:]))
    require(len(data[0]) == 2 * TRAIN_CLI_SAMPLES and len(data[1]) == TRAIN_CLI_VAL,
            f"train_cli: {len(data[0])} / {len(data[1])} samples")
    return data


def memory_pose_dataset(root, frames, cfg, rng):
    """The port's PoseDataset over a folder of placeholder PNG names and a
    real groundtruth.txt, its images served from ``frames`` ((left, right)
    uint8 (T, 1, H, W, 3) arrays)."""
    import os

    from robust_pose_tpu_torch.data.train_datasets import PoseDataset

    class MemoryPoseDataset(PoseDataset):
        def _read_img(self, path):
            name = os.path.basename(path)
            eye = frames[0] if name.endswith("l.png") else frames[1]
            img = eye[int(name[:-len("l.png")]) - 1, 0]
            return img.transpose(2, 0, 1).astype(np.float32)

    return MemoryPoseDataset(root, TRAIN_CLI_BF, PRODUCTION_K, 250.0, 0.0,
                             cfg["step"], (H, W), cfg["samples"], rng=rng)


def write_pose_sequence(root, n):
    """``video_frames/NNNNNNl.png`` / ``r.png`` placeholders and the
    groundtruth.txt of make_sequence's camera: 3 px a frame along x at
    depth TRAIN_CLI_BF / 8 (metres in the file)."""
    import os

    os.makedirs(os.path.join(root, "video_frames"))
    for k in range(1, n + 1):
        for eye in "lr":
            path = os.path.join(root, "video_frames", f"{k:06d}{eye}.png")
            open(path, "wb").close()
    dx = -3 * (TRAIN_CLI_BF / 8) / FX / 1000.0
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        for k in range(1, n + 1):
            f.write(f"{k} {(k - 1) * dx!r} 0.0 0.0 0.0 0.0 0.0 1.0\n")


class StepTimer:
    """A StageTimer that also keeps every stage's durations in order."""

    def __init__(self):
        from robust_pose_tpu_torch.utils.profiling import StageTimer

        self.inner, self.each = StageTimer(), {}

    def stage(self, name, sync=None):
        import contextlib

        @contextlib.contextmanager
        def timed():
            t0 = time.perf_counter()
            with self.inner.stage(name, sync):
                yield
            self.each.setdefault(name, []).append(time.perf_counter() - t0)

        return timed()


def watch_train_cli(record):
    """Record, for every PoseNetTrainer of the CLI: a StepProbe (installed
    by init_state), each train_step's metrics and launch deltas, and each
    validation's loss, launch delta and weights (on the CPU). Returns the
    undo."""
    from robust_pose_tpu_torch.scripts import train_posenet as cli
    from robust_pose_tpu_torch.train.trainer import PoseNetTrainer as PT

    init, step, val = PT.init_state, PT.train_step, cli.run_val

    def init_probed(self, *a, **kw):
        st = init(self, *a, **kw)
        record["probe"] = StepProbe(self)
        return st

    def step_counted(self, *a, **kw):
        before = launch_counts()
        state, metrics = step(self, *a, **kw)
        after = launch_counts()
        record["steps"].append({k: after[k] - before[k] for k in after})
        record["metrics"].append(metrics)
        return state, metrics

    def val_recorded(trainer, *a, **kw):
        before = launch_counts()
        loss = val(trainer, *a, **kw)
        after = launch_counts()
        record["vals"].append({
            "loss": loss, "launches": {k: after[k] - before[k] for k in after},
            "weights": {k: v.detach().cpu().clone()
                        for k, v in trainer.model.state_dict().items()}})
        return loss

    PT.init_state, PT.train_step, cli.run_val = init_probed, step_counted, val_recorded

    def undo():
        PT.init_state, PT.train_step, cli.run_val = init, step, val
        if "probe" in record:
            record["probe"].remove()

    return undo


def train_cli_run(dev, smi, name, cfg, sd, data, live):
    """The port's training CLI ``run`` (robust_pose_tpu_torch.scripts.
    train_posenet) on ``cfg`` with TRAIN_CLI_STEPS steps, validation every
    TRAIN_CLI_VAL_FREQ, the weights through save_checkpoint and
    --restore_ckpt, every launch counter set to 0 just before and read just
    after. Checks: the step count; every step's loss and gradient norm
    finite (but where reference_nan holds); RAFT bit-equal to the
    checkpoint; the heads moved; every validation loss finite; the best and
    the last bundle reload with load_checkpoint_any to the weights of their
    validation, bit for bit; the launches a step. Returns what it
    measured."""
    import contextlib
    import io
    import os
    import tempfile

    import torch

    from robust_pose_tpu_torch.scripts import train_posenet as cli
    from robust_pose_tpu_torch.utils.checkpoints import (
        load_checkpoint_any,
        save_checkpoint,
    )

    what = f"train_cli {name}"
    iters = cfg["model"]["iters"]
    record = {"steps": [], "metrics": [], "vals": []}
    timer = StepTimer()
    with tempfile.TemporaryDirectory() as root:
        save_checkpoint(os.path.join(root, "init"), sd, {"model": cfg["model"]})
        args = cli.build_parser().parse_args([
            "--name", "posenet", "--outpath", os.path.join(root, "out"),
            "--restore_ckpt", os.path.join(root, "init")])
        undo = watch_train_cli(record)
        val_freq, cli.VAL_FREQ = cli.VAL_FREQ, TRAIN_CLI_VAL_FREQ
        printed = io.StringIO()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(printed):
                state = cli.run(args, cfg, *data, timer=timer)
            torch.cuda.synchronize()
            loop_s = time.perf_counter() - t0
            launches = launch_counts()
        finally:
            cli.VAL_FREQ = val_freq
            undo()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        bundles = {b: load_checkpoint_any(os.path.join(root, "out", b))
                   ["state_dict"] for b in ("posenet", "posenet_last")}
    probe = record.pop("probe")
    metrics = record["metrics"]
    require(state.step == TRAIN_CLI_STEPS == len(metrics),
            f"{what}: {state.step} steps, {len(metrics)} recorded")
    ref_nan = check_steps(probe, metrics, what)
    del probe
    flow_moved = [k for k, v in state.params.items()
                  if k.startswith("flow.") and not torch.equal(v.detach().cpu(), sd[k])]
    heads_moved = [k for k, v in state.params.items()
                   if not k.startswith("flow.") and not torch.equal(v.detach().cpu(), sd[k])]
    require(not flow_moved, f"{what}: RAFT parameters moved: {flow_moved[:3]}")
    require(heads_moved, f"{what}: no head parameter moved")
    losses = [v["loss"] for v in record["vals"]]
    require(len(losses) == 2 and all(np.isfinite(losses)),
            f"{what}: validation losses {losses}")
    best = min(range(len(losses)), key=lambda i: (losses[i], i))
    for b, i in (("posenet", best), ("posenet_last", len(losses) - 1)):
        want = record["vals"][i]["weights"]
        require(set(bundles[b]) == set(want) and all(
            torch.equal(bundles[b][k], want[k]) for k in want),
            f"{what}: bundle {b} is not the weights of validation {i}")
    one_solve_a_call(launches, what)
    for i, lc in enumerate(record["steps"]):
        k1 = lc["corr_window_lookup"]
        require(lc["lm_solve"] == 1 and lc["instance_norm"] > 0
                and (lc["instance_norm_stats"] > 0) == live
                and lc["normal_eq"] == 0 and k1 == (0 if live else iters)
                and lc["lanewise_lookup"] == lc["lanewise_lookup_bwd"] == 0,
                f"{what}: step {i} launches {lc}")
    per_step = {k: record["steps"][1][k] for k in (
        "corr_window_lookup", "instance_norm", "instance_norm_stats", "lm_solve")}
    per_val = {k: record["vals"][0]["launches"][k] for k in per_step}
    # the timed steps: all but the first (warm-up); each ends in the log
    # stage's metric read back, a synchronize
    each = timer.each
    step_s = [each["data"][i] + each["step"][i] + each["log"][i]
              for i in range(1, TRAIN_CLI_STEPS)]
    out = {"phase": "train_cli", "config": name, "card": smi,
           "shape": [H, W], "batch": cfg["train"]["batch_size"],
           "model": {"lookup": "xla" if live else "auto (onthefly)",
                     "stop_flow_grad": not live, "remat": live,
                     "iters": iters, "lbgfs_iters": cfg["model"]["lbgfs_iters"]},
           "steps": TRAIN_CLI_STEPS, "timed_steps": len(step_s),
           "step_s": float(np.mean(step_s)), "step_s_each": step_s,
           "stage_s_each": {k: v for k, v in each.items()},
           "val_s": each["val"], "loop_s": loop_s,
           "bare_step_s": {k: TRAIN_STEP_S.get(f"train {k}") for k in "ab"},
           "peak_mem_gib": peak,
           "loss_total": [float(m["train/loss_total"]) for m in metrics],
           "grad_norm": [float(m["train/grad_norm"]) for m in metrics],
           "reference_nan": ref_nan, "val_losses": losses, "best_val": best,
           "launches_per_step": per_step, "launches_per_validation": per_val,
           "launches": launches,
           "printed": printed.getvalue().splitlines()[:2]}
    emit(out)
    return out


def bench_train_step_run(extra):
    """robust_pose_tpu_torch.scripts.bench_train_step.main at batch 8, 2
    timed steps, with ``extra`` flags; the launch counters over it."""
    import contextlib
    import io

    from robust_pose_tpu_torch.scripts import bench_train_step

    printed = io.StringIO()
    zero_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        res = bench_train_step.main(["--batch", str(TRAIN_BATCH), "--steps", "2",
                                     *extra])
    res.update(flags=extra, seconds=time.perf_counter() - t0,
               launches=launch_counts(), printed=printed.getvalue().splitlines())
    require(res["remat"]["fits"] and np.isfinite(res["remat"]["ms"]),
            f"bench_train_step {extra}: {res}")
    return res


def phase_train_cli(dev, smi):
    """The training CLI at full width on configuration/train.yaml as read
    (512x640, batch 8, 12 GRU iterations, 100 LM iterations, weight heads,
    freeze_flow_steps 10^18: lookup "xla" and remat with RAFT's gradients
    live and masked), from two training sequences and one validation
    sequence of make_sequence frames held in memory (placeholder PNG
    names, a real groundtruth.txt, the intrinsics and bf given directly).
    Cut: 4 steps, 40 training samples a sequence, 20 validation samples at
    the file's val.batch_size 10, validation every 2 steps. Run 1 as read,
    run 2 with train.stop_flow_grad (K1 inside the CLI). Then
    bench_train_step at batch 8, as is and with --live-flow-grads."""
    import copy

    import torch

    import tempfile

    cfg = train_cli_config(TRAIN_CLI_STEPS)
    sd = train_weights_full(cfg["model"])
    t0 = time.perf_counter()
    runs = {}
    with tempfile.TemporaryDirectory() as root:
        write_train_cli_sequences(root)
        data = train_cli_data(root, cfg)
        for name, live in (("as_read", True), ("stop_flow_grad", False)):
            c = copy.deepcopy(cfg)
            if not live:
                c["train"]["stop_flow_grad"] = True
            runs[name] = train_cli_run(dev, smi, name, c, sd, data, live)
            torch.cuda.empty_cache()
    bench = [bench_train_step_run([]), bench_train_step_run(["--live-flow-grads"])]
    TRAIN_CLI_BENCH.update(bench[0])
    emit({"phase": "train_cli", "part": "bench_train_step", "card": smi,
          "runs": bench, "seconds": time.perf_counter() - t0})
    return runs, bench


# ---------------------------------------------------------------------------
# phase ddp
# ---------------------------------------------------------------------------

DDP_WORLD = 2                 # case (ii), (iii): two gloo ranks on cuda:0
DDP_TIMEOUT_S = 120           # a collective that waits longer raises
DDP_JOIN_S = 600              # the spawned ranks' deadline
DDP_CLI_STEPS = 2             # case (iii): 2 steps, one validation (VAL_FREQ 2)
DDP_CLI_CASES = {"plain": 1, "accum": 2}   # case (iii): train.grad_accum
DDP_RTOL = 2e-3               # tests/test_torch_port_ddp.py's bounds
DDP_STATS_RTOL = 1e-4


def ddp_snapshot(st):
    """The train state's tensors cloned (on their device), as
    ``PoseNetTrainer.init_state(variables=...)`` takes them."""
    return {"state_dict": {**{k: v.detach().clone() for k, v in st.params.items()},
                           **{k: v.clone() for k, v in st.batch_stats.items()}},
            "mu": {k: v.clone() for k, v in st.opt_state.mu.items()},
            "nu": {k: v.clone() for k, v in st.opt_state.nu.items()},
            "count": st.opt_state.count, "step": st.step}


def ddp_cpu(snap):
    return {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict) else v)
            for k, v in snap.items()}


def ddp_errors(ref_m, ref, got_m, got):
    """Per item, the largest absolute difference of a step (metrics, the
    gradients its optimizer took, and the state after it: weights and
    statistics, Adam's moments) from another; and each item's scale (the
    reference's largest magnitude)."""
    err, scale = {}, {}
    for k, v in ref_m.items():
        err["metrics", k], scale["metrics", k] = abs(got_m[k] - v), abs(v)
    for g in DDP_GROUPS:
        for k, a in ref[g].items():
            err[g, k] = float((got[g][k].to(a.device) - a).abs().max())
            scale[g, k] = float(a.abs().max())
    return err, scale


DDP_GROUPS = ("state_dict", "grads", "mu", "nu")
DDP_PERTURB = 1e-7            # relative input perturbation of the sensitivity replay


def ddp_compare(err, scale, spread, lr):
    """A step against the bare trainer's step from the same state, by the
    CPU test's bounds (tests/test_torch_port_ddp.py) widened by the bare
    trainer's own spread on the card (``spread``: the errors of the other
    bare replays of the step, ddp_replay; bf16 gradients through the
    heads' bilinear resize, whose backward adds with atomics, differ from
    run to run, and a leaf whose gradient is rounding noise differs by its
    whole size).
    The CPU bounds: metrics rtol DDP_RTOL; gradients DDP_RTOL of the leaf's
    largest plus 2e-5 of the largest of all; Adam's moments DDP_RTOL of the
    leaf's largest plus 1e-6 of the largest of all; the heads' BatchNorm
    statistics rtol DDP_STATS_RTOL; weights within 2 lr x 1.02 plus 4 f32
    ulps of the leaf's largest, Adam's bound on two steps from one state
    (a step moves a weight by lr |m/sqrt(v)| <= 1.011 lr up to step 5, by
    Cauchy-Schwarz on the bias-corrected averages, then rounds; a weight
    whose gradient is rounding noise moves by ~lr either way, so at
    train.yaml's lr 1e-5 this is a sanity bound, and what the step computed
    is held by its gradients and moments). Widened: a
    metric or a statistic by 3 times its own spread; a gradient or a moment
    by 3 times the largest spread of its group (one replay's spread of a
    small leaf is too few samples to bound it). Per group: the worst error
    over its tolerance (<= 1 passes), where, the worst relative difference
    and the worst relative spread."""
    group_of = {}
    for g, k in err:
        if g == "state_dict":
            group_of[g, k] = ("stats" if k.endswith(("running_mean", "running_var"))
                              else "params")
        else:
            group_of[g, k] = g
    mmax, floor = {}, {}
    for item, grp in group_of.items():
        mmax[grp] = max(mmax.get(grp, 0.0), scale[item])
        floor[grp] = max(floor.get(grp, 0.0), spread[item])
    out = {}
    for item, e in err.items():
        grp, k = group_of[item], item[1]
        if grp == "stats":
            tol = DDP_STATS_RTOL * scale[item] + 3 * spread[item]
        elif grp == "params":
            tol = 2.04 * lr + 4 * 2.0 ** -23 * scale[item]
        elif grp == "metrics":
            tol = DDP_RTOL * scale[item] + 3 * spread[item]
        else:
            top = 2e-5 if grp == "grads" else 1e-6
            tol = DDP_RTOL * scale[item] + top * mmax[grp] + 3 * floor[grp]
        ratio = e / tol if tol else (0.0 if e == 0 else float("inf"))
        o = out.setdefault(grp, {"over_tol": 0.0, "at": None, "max_rel": 0.0,
                                 "bare_spread_max_rel": 0.0, "worst": []})
        if ratio > o["over_tol"]:
            o["over_tol"], o["at"] = ratio, k
        s = max(scale[item], 1e-30)
        o["max_rel"] = max(o["max_rel"], e / s)
        o["bare_spread_max_rel"] = max(o["bare_spread_max_rel"], spread[item] / s)
        # the worst items: over tolerance, error and spread over the item's
        # scale, the item's scale over the group's largest
        o["worst"] = sorted(o["worst"] + [(ratio, e / s, spread[item] / s,
                                           scale[item] / max(mmax[grp], 1e-30), k)],
                            reverse=True)[:3]
    return out


def ddp_check(comparisons, what):
    worst = {g: max(c[g]["over_tol"] for c in comparisons) for g in comparisons[0]}
    require(all(v <= 1.0 for v in worst.values()),
            f"{what}: off the bare trainer's step: {comparisons}")
    return {"worst_over_tol": worst, "steps": comparisons}


def ddp_control(comparisons, what):
    """The negative control: a step with the heads' BatchNorm on each
    rank's own statistics must miss the bare trainer's step, in the
    statistics and in the gradients."""
    worst = {g: max(c[g]["over_tol"] for c in comparisons) for g in comparisons[0]}
    require(worst["stats"] > 1.0 and worst["grads"] > 1.0,
            f"{what}: the local-statistics control passed the check: {worst}")
    return {"worst_over_tol": worst}


def ddp_perturbed(batch, seed=5):
    """``batch`` with its four images scaled by (1 + DDP_PERTURB N(0, 1))
    elementwise (seeded, on their device): a change below what splitting
    the batch does to the forward pass in f32 (ddp_batch_split)."""
    import torch

    g = torch.Generator(device=batch[0].device).manual_seed(seed)
    return tuple(x * (1 + DDP_PERTURB * torch.randn(x.shape, generator=g,
                                                     device=x.device))
                 if i < 4 else x for i, x in enumerate(batch))


def ddp_replay(dev, cfg, records, batch, perturb=False):
    """Each recorded step (a state before it, metrics, gradients and state
    after)
    replayed twice by the bare trainer (no mesh) from the same state on
    the whole global ``batch``, and with ``perturb`` once more on
    ``ddp_perturbed(batch)``; the comparisons (ddp_compare) against the
    first replay, the spread being the larger of the other replays'
    errors. A world of 2 computes on halves of the batch, whose
    convolutions round otherwise; the LM's iteration counts follow the
    last bits, and its implicit-function gradient moves with them
    (grad_norm by ~1e-3 under a 1e-7 input change on the card)."""
    from robust_pose_tpu_torch.train.trainer import PoseNetTrainer

    out = []
    for rec in records:
        bare = []
        for b in (batch, batch) + ((ddp_perturbed(batch),) if perturb else ()):
            tr = PoseNetTrainer(cfg, device=dev)
            st = tr.init_state(rec["before"])
            ddp_spy_grads(tr)
            st, m = tr.train_step(st, b)
            bare.append(({k: float(v) for k, v in m.items()},
                         {**ddp_snapshot(st), "grads": tr.last_grads}))
            del tr, st
        spread = {}
        for other in bare[1:]:
            e, _ = ddp_errors(*bare[0], *other)
            spread = {k: max(v, spread.get(k, 0.0)) for k, v in e.items()}
        err, scale = ddp_errors(*bare[0], rec["metrics"], rec["after"])
        out.append(ddp_compare(err, scale, spread, cfg["train"]["learning_rate"]))
    return out


def ddp_steps(tr, st, batch):
    """A warm-up step; TRAIN_TIMED steps timed as phase train times them
    (host clock around back-to-back steps ending in a synchronize) with the
    launch counters and the mesh's collective counts set to 0 just before
    and read just after; then TRAIN_TIMED more steps, each with the state
    before and after it and its gradients snapshotted (what the checks
    replay)."""
    import torch

    st, _ = tr.train_step(st, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    tr.mesh.calls.clear()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED):
        st, m = tr.train_step(st, batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_TIMED
    launches = launch_counts()
    per_step = {k: launches[k] / TRAIN_TIMED for k in (
        "corr_window_lookup", "instance_norm", "instance_norm_stats", "lm_solve",
        "lanewise_lookup", "lanewise_lookup_bwd")}
    calls = {k: v / TRAIN_TIMED for k, v in tr.mesh.calls.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    st, records = ddp_records(tr, st, batch)
    return st, records, {
        "step_s": dt, "peak_mem_gib": peak, "launches_per_step": per_step,
        "collectives_per_step": calls,
        "lm_iters": [r["iters"] for r in records],
        "loss_total": [r["metrics"]["train/loss_total"] for r in records]}


def ddp_spy_grads(tr):
    """Keep, as ``tr.last_grads``, a copy of the gradients each step hands
    its optimizer (averaged over ranks and microbatches)."""
    update = tr.optimizer.update

    def spy(params, grads, opt_state):
        tr.last_grads = {k: g.clone() for k, g in grads.items() if g is not None}
        return update(params, grads, opt_state)

    tr.optimizer.update = spy


def ddp_records(tr, st, batch, steps=TRAIN_TIMED):
    """``steps`` steps, each with the state before and after it and its
    gradients snapshotted (what the checks replay), its metrics and LM
    counts."""
    ddp_spy_grads(tr)
    records = []
    for _ in range(steps):
        before = ddp_snapshot(st)
        st, m = tr.train_step(st, batch)
        records.append({"before": before,
                        "after": {**ddp_snapshot(st), "grads": tr.last_grads},
                        "metrics": {k: float(v) for k, v in m.items()},
                        "iters": tr.last_solver_iters.tolist()})
        for k in ("train/loss_total", "train/grad_norm"):
            require(np.isfinite(records[-1]["metrics"][k]),
                    f"ddp: {k} {records[-1]['metrics'][k]}")
    return st, records


def ddp_batch_split(dev, cfg, sd, batch):
    """Why case (ii) is checked in f32: one process, the bare model in eval
    mode (no collective, no batch statistic), on the global batch and on
    its two halves; the largest difference of each output over its largest
    magnitude, in bf16 (``cfg``) and in f32. The convolutions of a batch
    of 4 and of 8 round otherwise in bf16."""
    import copy

    import torch

    from robust_pose_tpu_torch.train.trainer import PoseNetTrainer

    out = {}
    for prec, mp in (("bf16", True), ("f32", False)):
        c = copy.deepcopy(cfg)
        c["model"]["mixed_precision"] = mp
        tr = PoseNetTrainer(c, device=dev)
        tr.init_state(sd)
        img1, img2, img1r, img2r, m1, m2, _, K, bl = tr._nhwc_batch(batch)
        half = TRAIN_BATCH // 2
        with torch.no_grad():
            outs = [tr.model(img1[r], img2[r], K[r], bl[r], img1r[r], img2r[r],
                             m1[r], m2[r])
                    for r in (slice(None), slice(0, half), slice(half, None))]
        out[prec] = {}
        for name in ("flow", "stereo_flow2", "conf1", "conf2", "pose_tan"):
            a = getattr(outs[0], name).float()
            b = torch.cat([getattr(o, name) for o in outs[1:]]).float()
            out[prec][name] = float((a - b).abs().max() / a.abs().max())
        del tr, outs
    return out


def ddp_allreduce_profile(tr, st, batch):
    """One more step under torch.profiler: the busy ms and idle share of
    the step, and the train_step.allreduce span's host ms (under gloo the
    collective itself, staged through the host; under NCCL its enqueue),
    device ms (its window on the device timeline) and kernel ms."""
    prof = profile_run(lambda: tr.train_step(st, batch), "train_step.")
    span = prof.get("stages", {}).get("train_step.allreduce")
    return {"busy_ms": prof.get("device_busy_ms"),
            "idle_share": prof.get("idle_share"),
            "allreduce_span": None if span is None else {
                k: span[k] for k in ("host_ms", "device_ms", "kernel_ms",
                                     "launches")}}


def ddp_configs():
    """Phase train's (a) and (b): train.yaml with stop_flow_grad, and RAFT
    live through the lane-wise lookup."""
    import copy

    base = train_yaml()
    cfg_a = copy.deepcopy(base)
    cfg_a["train"]["stop_flow_grad"] = True
    cfg_b = copy.deepcopy(base)
    cfg_b["train"]["freeze_flow_steps"] = 0
    cfg_b["model"]["lookup"] = "lanewise"
    return {"a": cfg_a, "b": cfg_b}, train_weights_full(base["model"])


def ddp_f32(cfgs):
    """(a) and (b) in f32 (mixed_precision off), named "a_f32", "b_f32"."""
    import copy

    out = {}
    for name, cfg in cfgs.items():
        out[name + "_f32"] = c = copy.deepcopy(cfg)
        c["model"]["mixed_precision"] = False
    return out


def ddp_row_digests(batch):
    """Of each array of a batch, a digest of each row's bytes: which
    samples a step read, without keeping them."""
    import hashlib

    return [[hashlib.blake2b(r.tobytes(), digest_size=16).hexdigest()
             for r in x.cpu().numpy()] for x in batch]


def ddp_cli_config(accum):
    """Case (iii)'s CLI configuration: phase train_cli's train.yaml with
    stop_flow_grad, DDP_CLI_STEPS steps, in f32 (a batch split rounds like
    one process there: ddp_batch_split), ``accum`` microbatches."""
    cfg = train_cli_config(DDP_CLI_STEPS)
    cfg["train"]["stop_flow_grad"] = True
    cfg["train"]["grad_accum"] = accum
    cfg["model"]["mixed_precision"] = False
    return cfg


def ddp_cli(cfg, data, args_list, mesh=None):
    """The training CLI's run with validation every 2 steps: its step
    count, validation losses, final weights, and each step's metrics and
    the digests of the rows it read (this rank's)."""
    import contextlib
    import copy
    import io

    from robust_pose_tpu_torch.scripts import train_posenet as cli
    from robust_pose_tpu_torch.train.trainer import PoseNetTrainer

    losses, steps = [], []
    inner, freq, step = cli.run_val, cli.VAL_FREQ, PoseNetTrainer.train_step

    def recorded(*a, **kw):
        losses.append(inner(*a, **kw))
        return losses[-1]

    def train_step(self, state, batch):
        state, m = step(self, state, batch)
        steps.append({"rows": ddp_row_digests(batch),
                      "metrics": {k: float(v) for k, v in m.items()}})
        return state, m

    cli.run_val, cli.VAL_FREQ = recorded, 2
    PoseNetTrainer.train_step = train_step
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            state = cli.run(cli.build_parser().parse_args(args_list),
                            copy.deepcopy(cfg), *data, mesh=mesh)
    finally:
        cli.run_val, cli.VAL_FREQ = inner, freq
        PoseNetTrainer.train_step = step
    return {"step": state.step, "losses": losses, "steps": steps,
            "params": {k: v.detach().cpu() for k, v in state.params.items()}}


def ddp_rank(rank, addr, root):
    """One rank of cases (ii) and (iii), spawned: gloo on cuda:0 beside
    the other rank. (ii): (a) and (b) on this rank's 4 rows of the global
    batch, in bf16 and f32 (2 steps), and the local-statistics control,
    (a) in f32 (1 step);
    (iii): the training CLI of each DDP_CLI_CASES on this rank's rows of
    each batch, checkpoints into ``root/cli/rank<r>/<case>``. Results to
    ``root/rank<r>.pt``."""
    import torch

    from robust_pose_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from robust_pose_tpu_torch.train.trainer import PoseNetTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    res = {}
    cfgs, sd = ddp_configs()
    f32 = ddp_f32(cfgs)
    with make_mesh(dev, init_method=addr, rank=rank, world_size=DDP_WORLD,
                   backend="gloo", timeout_s=DDP_TIMEOUT_S) as mesh:
        batch = shard_batch(mesh, train_batch_full(dev))
        for name, cfg in {**cfgs, **f32, "a_f32_local": f32["a_f32"]}.items():
            tr = PoseNetTrainer(cfg, mesh=mesh)
            st = tr.init_state(sd)
            out = None
            if name.endswith("_local"):
                # the heads' BatchNorm on this rank's own statistics
                forward = tr.model.forward
                tr.model.forward = lambda *a, mesh=None, **kw: forward(*a, **kw)
            if name in cfgs:
                # bf16, phase train's configuration: timed and profiled
                st, records, out = ddp_steps(tr, st, batch)
                out.update(ddp_allreduce_profile(tr, st, batch))
            else:
                st, records = ddp_records(tr, st, batch,
                                          1 if name.endswith("_local") else TRAIN_TIMED)
            res[name] = {"records": [{**r, "before": ddp_cpu(r["before"]),
                                      "after": ddp_cpu(r["after"])}
                                     for r in records], "out": out}
            del tr, st, records
            torch.cuda.empty_cache()
        data = train_cli_data(root, ddp_cli_config(1))
        for case, accum in DDP_CLI_CASES.items():
            res["cli", case] = ddp_cli(ddp_cli_config(accum), data, [
                "--name", "posenet", "--outpath", f"{root}/cli/rank{rank}/{case}",
                "--restore_ckpt", f"{root}/init"], mesh)
    torch.save(res, f"{root}/rank{rank}.pt")


def ddp_cli_check(dev, root, sd, data, case, ranks, spread):
    """Case (iii) for one of DDP_CLI_CASES: only rank 0 wrote, and its
    checkpoints load into a world-1 trainer; of each step, the ranks' rows
    put together in the JAX layout (of each microbatch, the ranks' shares
    in rank order) are a world-1 CLI run's global batch, and the metrics
    are its own within DDP_RTOL plus 3 times ``spread`` (relative: how far
    case (ii)'s f32 metrics moved under a 1e-7 input change; the second
    step starts from states that differ, and the f32 LM's counts follow
    the last bits); the weights within 2 lr a step plus 1e-4 of the leaf's
    largest (RAFT bit for bit), the validation loss within DDP_RTOL."""
    import os

    import torch

    from robust_pose_tpu_torch.train.trainer import PoseNetTrainer
    from robust_pose_tpu_torch.utils.checkpoints import load_checkpoint_any

    accum = DDP_CLI_CASES[case]
    cfg = ddp_cli_config(accum)
    c0, c1 = (r["cli", case] for r in ranks)
    what = f"ddp (iii) {case}"
    require(sorted(os.listdir(f"{root}/cli/rank0/{case}")) == ["posenet", "posenet_last"]
            and not os.path.exists(f"{root}/cli/rank1"),
            f"{what}: checkpoints written by a rank other than 0")
    require(c0["step"] == c1["step"] == DDP_CLI_STEPS and len(c0["losses"]) == 1
            and c0["losses"] == c1["losses"] and np.isfinite(c0["losses"]).all(),
            f"{what}: steps {c0['step']}, {c1['step']}, losses "
            f"{c0['losses']}, {c1['losses']}")
    one = ddp_cli(cfg, data, [
        "--name", "posenet", "--outpath", f"{root}/cli/world1/{case}",
        "--restore_ckpt", f"{root}/init"])
    require(len(one["steps"]) == len(c0["steps"]) == len(c1["steps"]) == DDP_CLI_STEPS,
            f"{what}: steps recorded {len(one['steps'])}, {len(c0['steps'])}")
    metrics_rel = []
    for s, a, b in zip(one["steps"], c0["steps"], c1["steps"]):
        require(a["metrics"] == b["metrics"] and a["rows"][0] != b["rows"][0],
                f"{what}: the ranks' metrics differ or their images are equal")
        for want, x0, x1 in zip(s["rows"], a["rows"], b["rows"]):
            m = len(x0) // accum
            got = [d for i in range(accum) for x in (x0, x1)
                   for d in x[i * m:(i + 1) * m]]
            require(got == want,
                    f"{what}: the ranks' rows are not world 1's global batch")
        metrics_rel.append({k: abs(a["metrics"][k] - v) / abs(v)
                            for k, v in s["metrics"].items()})
    metrics_tol = DDP_RTOL + 3 * spread
    metrics_worst = max(max(m.values()) for m in metrics_rel)
    lr = cfg["train"]["learning_rate"]
    worst = {"params_over_tol": 0.0, "at": None}
    for which in ("posenet", "posenet_last"):
        got = load_checkpoint_any(f"{root}/cli/rank0/{case}/{which}")["state_dict"]
        want = load_checkpoint_any(f"{root}/cli/world1/{case}/{which}")["state_dict"]
        tr = PoseNetTrainer(cfg, device=dev)
        tr.init_state(got)
        loaded = tr.model.state_dict()
        require(all(torch.equal(loaded[k].cpu(), v) for k, v in got.items()),
                f"{what}: {which} does not load into a world-1 trainer")
        for k, w in want.items():
            if k.startswith("flow."):
                require(torch.equal(got[k], w) and torch.equal(got[k], sd[k]),
                        f"{what}: RAFT moved: {k}")
                continue
            tol = 2 * lr * DDP_CLI_STEPS + 1e-4 * float(w.abs().max())
            r = float((got[k] - w).abs().max()) / tol
            if r > worst["params_over_tol"]:
                worst = {"params_over_tol": r, "at": f"{which} {k}"}
        del tr
    val_rel = abs(c0["losses"][0] - one["losses"][0]) / abs(one["losses"][0])
    require(worst["params_over_tol"] <= 1.0 and val_rel <= DDP_RTOL
            and metrics_worst <= metrics_tol,
            f"{what}: off the world-1 CLI: {worst}, metrics rel {metrics_rel} "
            f"(tolerance {metrics_tol}), val loss {c0['losses']} against "
            f"{one['losses']}")
    return {"grad_accum": accum, "val_loss": c0["losses"],
            "world1_val_loss": one["losses"], "val_loss_rel_diff": val_rel,
            "metrics_rel_diff": metrics_rel, "metrics_rel_tol": metrics_tol,
            "metrics": [a["metrics"] for a in c0["steps"]],
            "rows_are_world1_batch": True, "vs_world1_weights": worst}


def phase_ddp(dev, smi):
    """Data parallelism at full width (configuration/train.yaml, 512x640,
    global batch 8, phase train's weights and batch, TF32 off), four cases:
    (i) a world of 1 under NCCL through the mesh path, (a) and (b), against
    the bare trainer's steps from the same states; (ii) a world of 2 under
    gloo, both ranks on cuda:0 (spawned), 4 rows a rank: (a) and (b) timed
    and profiled in bf16, the ranks' states bit for bit, and each step of
    (a) and (b) in f32 against the bare trainer's on the whole batch from
    the same state (in bf16 a batch of 4 and one of 8 round otherwise:
    ddp_batch_split), and the local-statistics control, which must fail
    that check; (iii) the training CLI at world 2, in f32, with grad_accum
    1 and 2 (ddp_cli_check); (iv) bench_train_step at world 1 under NCCL
    beside phase train_cli's."""
    import contextlib
    import io
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from robust_pose_tpu_torch.parallel.mesh import free_tcp_address, make_mesh
    from robust_pose_tpu_torch.scripts import bench_train_step
    from robust_pose_tpu_torch.train.trainer import PoseNetTrainer
    from robust_pose_tpu_torch.utils.checkpoints import save_checkpoint

    t_phase = time.perf_counter()
    seconds = {}
    cfgs, sd = ddp_configs()
    batch = train_batch_full(dev)
    # (i) and (iv): a world of 1 under NCCL
    with make_mesh(torch.device("cuda", 0), init_method=free_tcp_address(),
                   rank=0, world_size=1, timeout_s=DDP_TIMEOUT_S) as mesh:
        for name, cfg in cfgs.items():
            tr = PoseNetTrainer(cfg, mesh=mesh)
            st = tr.init_state(sd)
            st, records, out = ddp_steps(tr, st, batch)
            out.update(ddp_allreduce_profile(tr, st, batch))
            del tr, st
            worst = ddp_check(ddp_replay(dev, cfg, records, batch),
                              f"ddp (i) {name}")
            bare = TRAIN_STEP_S.get(f"train {name}")
            emit({"phase": "ddp", "case": "i", "config": name, "card": smi,
                  "world_size": 1, "backend": mesh.backend, "batch": TRAIN_BATCH,
                  **out, "bare_step_s": bare,
                  "step_over_bare": None if bare is None else out["step_s"] / bare,
                  "vs_bare_trainer": worst})
            del records
            torch.cuda.empty_cache()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            bench = bench_train_step.main(["--batch", str(TRAIN_BATCH),
                                           "--steps", "2"], mesh=mesh)
        span = bench["remat"]["allreduce_span"]
        require(bench["remat"]["fits"] and np.isfinite(bench["remat"]["ms"])
                and span["host_ms"] is not None and span["device_ms"] is not None,
                f"ddp (iv): {bench}")
        emit({"phase": "ddp", "case": "iv", "card": smi, "world_size": 1,
              "bench_train_step": bench,
              "printed": printed.getvalue().splitlines(),
              "train_cli_bench": {k: TRAIN_CLI_BENCH.get(k)
                                  for k in ("noremat", "remat")}})
    torch.cuda.empty_cache()
    seconds["i_iv"] = time.perf_counter() - t_phase
    # (ii) and (iii): a world of 2 under gloo, both ranks on cuda:0
    with tempfile.TemporaryDirectory() as root:
        write_train_cli_sequences(root)
        save_checkpoint(f"{root}/init", sd, {"model": ddp_cli_config(1)["model"]})
        t0 = time.perf_counter()
        ctx = mp.start_processes(ddp_rank, args=(free_tcp_address(), root),
                                 nprocs=DDP_WORLD, join=False,
                                 start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                require(time.perf_counter() - t0 < DDP_JOIN_S,
                        "ddp: the spawned ranks did not finish")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
        seconds["spawned_ranks"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = [torch.load(f"{root}/rank{r}.pt", weights_only=False)
                 for r in range(DDP_WORLD)]
        split = ddp_batch_split(dev, cfgs["a"], sd, batch)
        f32 = ddp_f32(cfgs)
        for name, cfg in {**cfgs, **f32, "a_f32_local": f32["a_f32"]}.items():
            r0, r1 = (r[name] for r in ranks)
            control = name.endswith("_local")
            for a, b in zip(r0["records"], r1["records"]):
                # the control's ranks keep their own running statistics
                require(control or a["metrics"] == b["metrics"] and all(
                    torch.equal(a["after"][g][k], b["after"][g][k])
                    for g in DDP_GROUPS for k in a["after"][g]),
                    f"ddp (ii) {name}: the ranks' states differ")
            line = {"phase": "ddp", "case": "ii", "config": name, "card": smi,
                    "world_size": DDP_WORLD, "backend": "gloo",
                    "device": "cuda:0", "rows_a_rank": TRAIN_BATCH // DDP_WORLD,
                    "ranks_bit_equal": not control}
            if name in cfgs:
                line.update(ranks=[r[name]["out"] for r in ranks],
                            bf16_batch_split=split)
            elif control:
                line["control_vs_world1"] = ddp_control(
                    ddp_replay(dev, cfg, r0["records"], batch, perturb=True),
                    f"ddp (ii) {name}")
            else:
                # f32: a batch split rounds like one process (split["f32"])
                line["vs_world1"] = ddp_check(
                    ddp_replay(dev, cfg, r0["records"], batch, perturb=True),
                    f"ddp (ii) {name}")
            emit(line)
            if name == "a_f32":
                spread = max(c["metrics"]["bare_spread_max_rel"]
                             for c in line["vs_world1"]["steps"])
        seconds["ii_checks"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        data = train_cli_data(root, ddp_cli_config(1))
        for case in DDP_CLI_CASES:
            emit({"phase": "ddp", "case": "iii", "config": case, "card": smi,
                  "world_size": DDP_WORLD, "backend": "gloo",
                  "steps": DDP_CLI_STEPS,
                  **ddp_cli_check(dev, root, sd, data, case, ranks, spread)})
        seconds["iii_checks"] = time.perf_counter() - t0
    emit({"phase": "ddp", "seconds": time.perf_counter() - t_phase,
          "by_part": seconds})


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = phase_device()
    count_solve_pose()
    if sys.argv[1:] == ["kernels"]:
        # the kernels phase alone, three times over (its spread), for work
        # on one kernel; prints no result line
        for _ in range(3):
            phase_kernels(dev)
        return 0
    if sys.argv[1:] == ["small_train"]:
        # RAFT small's training step, many times over (ROADMAP section C);
        # prints no result line
        phase_small_train_repro(dev, smi)
        return 0
    if sys.argv[1:] == ["cli"]:
        # phase main (for its FPS) and the CLI phase; no result line
        phase_main(dev, smi)
        phase_cli(dev, smi)
        return 0
    if sys.argv[1:] == ["bench"]:
        # phases main and f2m (for their FPS) and the port's bench; no
        # result line
        phase_main(dev, smi)
        phase_f2m(dev, smi)
        phase_bench(dev, smi)
        return 0
    if sys.argv[1:] == ["train_cli"]:
        # phase train (the bare step) and the training CLI; no result line
        phase_train(dev, smi)
        phase_train_cli(dev, smi)
        return 0
    if sys.argv[1:] == ["ddp"]:
        # phase train (the bare step) and data parallelism; no result line
        phase_train(dev, smi)
        phase_ddp(dev, smi)
        return 0
    if sys.argv[1:] == ["tools"]:
        # the parity harness, the roofline and the profile tools; no
        # result line
        phase_parity(dev, smi)
        phase_roofline(dev, smi)
        phase_tools(dev, smi)
        return 0
    kernels = phase_kernels(dev)
    phase_slice(dev)
    launches = phase_main(dev, smi)
    phase_train_slice(dev)
    train = phase_train(dev, smi)
    phase_f2m_slice(dev)
    _, f2m_grouped = phase_f2m(dev, smi)
    small_case = phase_slice(dev, small=True)
    phase_train_slice(dev, small=True)
    small_f2f, small_train = phase_small(dev, smi)
    phase_checkpoints(dev, *small_case)
    phase_cli(dev, smi)
    phase_ops_tail(dev)
    phase_train_cli(dev, smi)
    phase_ddp(dev, smi)
    phase_parity(dev, smi)
    phase_roofline(dev, smi)
    phase_tools(dev, smi)
    phase_bench(dev, smi)
    # each kernel's launches on its own path: K1-K3 and the K2 norm in the
    # f2f main path (K3: the LM solve kernel, one launch a window, every
    # build inside), K4-K5 and K2's statistics entry (the norms' backward)
    # in the training step with live RAFT, K7 in the f2m window with
    # lookup "grouped"; K6 has no path (none in the JAX package either);
    # RAFT small's K1 (radius 3) and K2 norm (its widths) in its f2f
    # windows, its K4-K5 (radius 3) and K2 statistics in its training
    # step ("dots")
    launches["normal_eq"] = launches["lm_solve"]
    launches.update({k: train["b"][k] for k in (
        "lanewise_lookup", "lanewise_lookup_bwd", "instance_norm_stats")})
    launches.update(pixel_lookup=0, grouped_lookup=f2m_grouped["grouped_lookup"])
    launches.update(
        corr_window_lookup_r3=small_f2f["corr_window_lookup"],
        instance_norm_small=small_f2f["instance_norm"],
        instance_norm_stats_small=small_train["instance_norm_stats"],
        lanewise_lookup_r3=small_train["lanewise_lookup"],
        lanewise_lookup_bwd_r3=small_train["lanewise_lookup_bwd"])
    for k in kernels:
        k["launches"] = launches[k["name"]]
    emit({"kernels": [{key: k[key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
        "device_ms", "host_us", "plain_ms", "bound_ms", "bound_by",
        "library_ms")} for k in kernels]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
