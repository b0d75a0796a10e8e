#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (robust_pose_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device   -- the card (nvidia-smi name and power limit, printed raw on
               their own line), torch/CUDA versions, kernel build time
               (nvcc over robust_pose_tpu_torch/csrc/*.cu, one process per
               source, in parallel).
2. kernels  -- each hand-written kernel against its plain PyTorch version on
               the card at the shapes of the main path (512x640 f2f, 8-frame
               windows): max error vs the stated tolerance, kernel time,
               plain time, the time of one PyTorch library call computing
               the same function where one exists, and the least time the
               card could take (bytes over 3.35 TB/s or operations over the
               peak rate of their type).
3. slice    -- the port's f2f path at 64x96 in f32 with TF32 off, once on
               the card through the kernels and once on the CPU through the
               plain versions: poses, success flags and masks must agree.
4. main     -- production f2f at full width (512x640, T = 8, 12 GRU
               iterations, 20 LM iterations, confidence heads, 3 UNet
               levels, bf16 mixed precision), random seeded weights, the
               synthetic sequence of bench.py: first frame, 2 warm-up and 4
               timed windows with every launch counter set to 0 just before
               and read just after; then a bf16-vs-f32 pose check.

Then one line {"kernels": [...]} and, last, {"ok": true, "device": ...}.
Every failed check raises: the script exits non-zero and prints no result.
TF32 stays off throughout (f32 products and convolutions in full f32).
"""
import json
import subprocess
import sys
import time

import numpy as np

H, W = 512, 640
T_WINDOW = 8
N_TIMED = 4                   # timed windows of the main path
FX = 500.0
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
BF16_FLOPS = 989e12           # dense tensor-core bf16
F32_FLOPS = 67e12             # f32 outside the tensor cores


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
    require(set(libs) == {"corr_onthefly", "normal_eq"}, f"built {set(libs)}")
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

def kernel_corr(dev):
    """K1 at the main path's shapes: B = 2T = 16, 64x80 queries, C = 256,
    bf16 features (f2 pooled in f32, then cast), all 4 levels."""
    import torch

    from robust_pose_tpu_torch.ops import corr_onthefly as K1

    g = torch.Generator(device=dev).manual_seed(1)
    b, h8, w8, c = 2 * T_WINDOW, H // 8, W // 8, 256
    f1 = torch.randn(b, h8 * w8, c, generator=g, device=dev).bfloat16()
    f2 = torch.randn(b, h8, w8, c, generator=g, device=dev)
    levels = [l.bfloat16().contiguous() for l in K1.pool_fmap_pyramid(f2)]
    ys, xs = torch.meshgrid(torch.arange(h8, device=dev, dtype=torch.float32),
                            torch.arange(w8, device=dev, dtype=torch.float32),
                            indexing="ij")
    coords = torch.stack([xs, ys], -1).reshape(1, -1, 2) + 4.0 * torch.randn(
        b, h8 * w8, 2, generator=g, device=dev)
    coords[:, :200] -= 40.0                       # windows off the map
    coords = coords.contiguous()
    scales = [float(2 ** l) for l in range(4)]

    def kernel():
        return [K1.corr_lookup_level(f1, f2l, coords, 4, s)
                for f2l, s in zip(levels, scales)]

    def plain():
        return [K1.corr_lookup_level_plain(f1, f2l, coords, 4, s)
                for f2l, s in zip(levels, scales)]

    err = max(float((k - p).abs().max()) for k, p in zip(kernel(), plain()))
    tol = 1e-4    # f32 sums of 256 bf16 products, in different orders
    require(err <= tol, f"corr lookup max |err| {err} > {tol}")
    saved = K1.launches
    ms = cuda_time_ms(kernel)
    plain_ms = cuda_time_ms(plain, reps=3, warmup=1)
    K1.launches = saved
    # bytes: f1, the 4 f2 levels and coords read once, 4 outputs written once
    nbytes = (f1.numel() * 2 + sum(l.numel() * 2 for l in levels)
              + coords.numel() * 4 + 4 * b * 81 * h8 * w8 * 4)
    # operations: one C-long multiply-add per in-bounds window pixel (the
    # 10x10 pixels a radius-4 bilinear window touches), bf16 inputs
    ops = 0
    for l, s in zip(levels, scales):
        hl, wl = l.shape[1:3]
        cy0 = torch.floor(coords[..., 1] / s) - 4
        cx0 = torch.floor(coords[..., 0] / s) - 4
        dd = torch.arange(10, device=dev)
        ny = ((cy0[..., None] + dd >= 0) & (cy0[..., None] + dd < hl)).sum(-1)
        nx = ((cx0[..., None] + dd >= 0) & (cx0[..., None] + dd < wl)).sum(-1)
        ops += int((ny * nx).sum()) * c * 2
    bound = max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS) * 1e3
    return {"name": "corr_window_lookup", "route": "cuda",
            "source": "robust_pose_tpu_torch/csrc/corr_onthefly.cu",
            "replaces": "robust_pose_tpu/ops/pallas_corr_onthefly.py:64",
            "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / BF16_FLOPS
            else "operations",
            "library_ms": None, "unit": "one 4-level lookup (4 launches)",
            "bytes": nbytes, "ops": ops}


def kernel_instance_norm(dev):
    """K2 at the three fnet shapes (B = 16, bf16); the time of one fnet
    pass's 15 norms = 5 x (t(256x320x64) + t(128x160x96) + t(64x80x128))."""
    import torch

    from robust_pose_tpu_torch.ops import instance_norm as K2

    g = torch.Generator(device=dev).manual_seed(2)
    b = 2 * T_WINDOW
    shapes = [(H // 2, W // 2, 64), (H // 4, W // 4, 96), (H // 8, W // 8, 128)]
    per = []
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "ops": 0}
    err_all = 0.0
    for h, w, c in shapes:
        x = (torch.randn(b, h, w, c, generator=g, device=dev) * 2.0 + 0.5
             ).bfloat16()
        s_k, ss_k = K2.instance_norm_stats(x)
        s_p, ss_p = K2.instance_norm_stats_plain(x)
        # tolerance relative to the sums' magnitude: f32 sums of h*w terms
        # in different orders
        err = max(float(((s_k - s_p).abs() / (s_p.abs() + h * w * 1e-2)).max()),
                  float(((ss_k - ss_p).abs() / ss_p.abs()).max()))
        require(err <= 1e-5, f"instance_norm_stats {h}x{w}x{c} rel err {err}")
        err_all = max(err_all, float((s_k - s_p).abs().max()),
                      float((ss_k - ss_p).abs().max()))
        saved = K2.launches
        ms = cuda_time_ms(lambda: K2.instance_norm_stats(x))
        K2.launches = saved
        plain_ms = cuda_time_ms(lambda: K2.instance_norm_stats_plain(x), reps=5)
        lib_ms = cuda_time_ms(lambda: (torch.sum(x, (1, 2), dtype=torch.float32),
                                       torch.sum(x * x, (1, 2),
                                                 dtype=torch.float32)))
        nbytes = x.numel() * 2 + 2 * b * c * 4
        ops = 3 * x.numel()          # add, multiply-add per element (f32)
        per.append({"shape": [b, h, w, c], "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "rel_err": err})
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                     ("bytes", nbytes), ("ops", ops)):
            tot[k] += 5 * v
    bound = max(tot["bytes"] / HBM_BYTES_PER_S, tot["ops"] / F32_FLOPS) * 1e3
    return {"name": "instance_norm_stats", "route": "triton",
            "source": "robust_pose_tpu_torch/ops/instance_norm.py",
            "replaces": "robust_pose_tpu/ops/pallas_instance_norm.py:27",
            "max_abs_err": err_all, "tol": "rel 1e-5", "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": bound,
            "bound_by": "bytes" if tot["bytes"] / HBM_BYTES_PER_S
            >= tot["ops"] / F32_FLOPS else "operations",
            "library_ms": tot["library_ms"],
            "unit": "one fnet pass: 15 norms (15 launches)",
            "bytes": tot["bytes"], "ops": tot["ops"], "per_shape": per}


def kernel_normal_eq(dev):
    """K3 at B = T = 8, 512x640, f32, at a random pose with random weights
    and masks; also checks that two runs give the same bits."""
    import torch

    from robust_pose_tpu_torch import se3
    from robust_pose_tpu_torch.ops import normal_eq as K3
    from robust_pose_tpu_torch.ops.geometry import create_img_coords, depth_to_pcl
    from robust_pose_tpu_torch.solver.objectives import PoseProblemInputs

    g = torch.Generator(device=dev).manual_seed(3)
    b = T_WINDOW
    r = lambda *s: torch.rand(*s, generator=g, device=dev)
    K = torch.tensor([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]],
                     device=dev).expand(b, 3, 3)
    coords = create_img_coords(H, W, device=dev)
    pcl1 = depth_to_pcl(0.2 + 0.8 * r(b, H, W, 1), K, coords)
    pose_gt = se3.exp(0.02 * torch.randn(b, 6, generator=g, device=dev))
    pp = se3.act(pose_gt[:, None], pcl1.reshape(b, -1, 3))
    proj = pp @ K.transpose(1, 2)
    flow = proj[..., :2] / proj[..., 2:] - coords[None, :, :2]
    xs = PoseProblemInputs(
        flow=(flow + 0.3 * torch.randn(flow.shape, generator=g, device=dev)
              ).reshape(b, H, W, 2),
        pcl1=pcl1, pcl2=(pp + 0.01 * torch.randn(pp.shape, generator=g,
                                                 device=dev)).reshape(b, H, W, 3),
        weights1=r(b, H, W, 1), weights2=r(b, H, W, 1),
        mask1=r(b, H, W, 1) > 0.1, mask2=r(b, H, W, 1) > 0.2, intrinsics=K,
        loss_weight=torch.tensor([[0.5, 1.5]], device=dev).expand(b, 2))
    planes, kvec = K3.pack_planes(xs, H, W)
    pose = se3.exp(0.01 * torch.randn(b, 6, generator=g, device=dev))
    lw = xs.loss_weight.contiguous()
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
    ms = cuda_time_ms(lambda: K3.normal_equations(pose, planes, kvec, lw, H, W))
    K3.launches = saved
    plain_ms = cuda_time_ms(
        lambda: K3.normal_equations_plain(pose, planes, kvec, lw, H, W), reps=5)
    # bytes: the 10 planes the math reads (pcl1, pcl2, flow, 2 weights) and
    # pose/K/loss weights, read once; H, g, cost written once
    nbytes = b * 10 * H * W * 4 + b * (7 + 4 + 2) * 4 + b * 43 * 4
    ops = b * H * W * 260          # f32 operations per pixel (see normal_eq.cu)
    bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
    return {"name": "normal_eq", "route": "cuda",
            "source": "robust_pose_tpu_torch/csrc/normal_eq.cu",
            "replaces": "robust_pose_tpu/ops/pallas_normal_eq.py:61",
            "max_abs_err": float((Hk - Hp).abs().max()),
            "rel_err": {"kernel_vs_f64": err_k64, "plain_vs_f64": err_p64,
                        "kernel_vs_plain": err_kp},
            "tol": {"kernel_vs_f64": 1e-4, "kernel_vs_plain": tol_kp},
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOPS
            else "operations",
            "library_ms": None, "unit": "one H/g/cost build (1 launch)",
            "bytes": nbytes, "ops": ops}


def phase_kernels(dev):
    import torch

    t0 = time.perf_counter()
    out = [kernel_corr(dev), kernel_instance_norm(dev), kernel_normal_eq(dev)]
    torch.cuda.synchronize()
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0,
          "kernels": out})
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


def phase_slice(dev):
    """64x96, f32, the same weights and frames on the card (kernels) and on
    the CPU (plain versions); tolerances of tests/test_torch_port_slice.py."""
    import torch

    from robust_pose_tpu_torch.slam.pose_estimator import PoseEstimator

    h, w = 64, 96
    model_cfg = {"image_shape": (h, w), "iters": 2, "lbgfs_iters": 5,
                 "use_weights": True, "mixed_precision": False, "unet_levels": 1}
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
                      "niter": est.last_solver_iters.cpu()}
    c, p = res["cuda"], res["cpu"]
    dist = tangent_distance(c["poses"], p["poses"])
    require(bool(p["succ"].any()), "slice: degenerate sequence, every frame failed")
    require(torch.equal(c["succ"], p["succ"]), "slice: success flags differ")
    require(torch.equal(c["first_valid"], p["first_valid"])
            and torch.equal(c["carry_valid"], p["carry_valid"]),
            "slice: depth-valid masks differ")
    require(dist <= 1e-4, f"slice: pose tangent distance {dist} > 1e-4")
    emit({"phase": "slice", "shape": [h, w], "pose_tangent_dist": dist,
          "tol": 1e-4, "success": c["succ"].tolist(),
          "niter_cuda": c["niter"].tolist(), "niter_cpu": p["niter"].tolist(),
          "valid_fraction": float(c["first_valid"].float().mean())})


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def production_estimator(dev, mixed_precision, state_dict=None, disparity=8):
    import torch

    from robust_pose_tpu_torch.models.posenet import PoseNet
    from robust_pose_tpu_torch.slam.pose_estimator import PoseEstimator

    model_cfg = {"image_shape": (H, W), "iters": 12, "lbgfs_iters": 20,
                 "use_weights": True, "unet_levels": 3,
                 "mixed_precision": mixed_precision}
    slam = {"frame2frame": True, "lbgfs_iters": 20, "conf_weighing": True,
            "depth_clipping": [1, 250], "dist_thr": 0.05, "average_pts": False}
    if state_dict is None:
        m = PoseNet(model_cfg, device=dev)
        m.reset_parameters(torch.Generator().manual_seed(0))
        # bench.py's flow head: zero kernel, bias = disparity / (8 * iters)
        fh = m.flow.update["update_block"].flow_head.conv2
        with torch.no_grad():
            fh.weight.zero_()
            fh.bias.copy_(torch.tensor([-disparity / (8.0 * 12), 0.0]))
        state_dict = {k: v.cpu() for k, v in m.state_dict().items()}
        del m
    K = np.array([[FX, 0.0, W / 2], [0.0, FX, H / 2], [0.0, 0.0, 1.0]])
    est = PoseEstimator(slam, K, 16.0, {"state_dict": state_dict,
                                        "config": {"model": model_cfg}},
                        (W, H), device=dev)
    return est, state_dict


def phase_main(dev, smi):
    import torch

    from robust_pose_tpu_torch import se3
    from robust_pose_tpu_torch.ops import corr_onthefly as K1
    from robust_pose_tpu_torch.ops import instance_norm as K2
    from robust_pose_tpu_torch.ops import normal_eq as K3

    est, sd = production_estimator(dev, True)
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

    K1.launches = K2.launches = K3.launches = 0
    t0 = time.perf_counter()
    succs, poses = [], None
    for i in range(n_timed):
        poses, succ = est.track_window(windows[i][0], windows[i][1], masks)
        succs.append(succ)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"corr_window_lookup": K1.launches,
                "instance_norm_stats": K2.launches, "normal_eq": K3.launches}

    require(bool(torch.isfinite(poses).all()), "main: non-finite poses")
    require(launches["corr_window_lookup"] == 48 * n_timed,
            f"main: corr lookups {launches}")
    require(launches["instance_norm_stats"] == 15 * n_timed,
            f"main: instance norms {launches}")
    require(2 * n_timed <= launches["normal_eq"] <= 21 * n_timed,
            f"main: normal equations {launches}")
    succ = torch.cat(succs)
    it = est.last_solver_iters.cpu()
    fps = n_timed * T_WINDOW / dt

    # bf16 vs f32 on one window from the same first frame and weights
    rel = {}
    for mp in (True, False):
        e, _ = production_estimator(dev, mp, state_dict=sd)
        e(ls[0], rs[0], mask1)
        p, _ = e.track_window(windows[0][0], windows[0][1], masks)
        prev = torch.cat([e.last_pose.new_tensor([[0, 0, 0, 0, 0, 0, 1.0]]),
                          p[:-1, 0]])
        rel[mp] = se3.mul(se3.inv(p[:, 0]), prev)            # per-frame rel
        del e
    deltas = [tangent_distance(rel[True][i:i + 1], rel[False][i:i + 1])
              for i in range(T_WINDOW)]
    require(max(deltas) < 2e-2, f"main: bf16-vs-f32 pose deltas {deltas}")
    emit({"phase": "main", "card": smi, "shape": [H, W], "window": T_WINDOW,
          "timed_windows": n_timed, "fps": fps, "seconds": dt,
          "success_rate": float(succ.float().mean()),
          "lm_iters": {"mean": float(it.float().mean()), "max": int(it.max()),
                       "min": int(it.min())},
          "launches": launches,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "bf16_vs_f32_pose_delta": deltas})
    phase_profile(est, windows[0], masks)
    return launches


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

KERNEL_GROUPS = (            # (group, substrings of the device kernel name)
    ("corr_window_lookup (K1)", ("corr_window",)),
    ("instance_norm_stats (K2)", ("_stats_partial", "_stats_finish")),
    ("normal_eq (K3)", ("normal_eq",)),
    ("convolutions and products", ("conv", "cudnn", "xmma", "gemm", "sm90_",
                                   "cutlass", "implicit")),
    ("elementwise, reductions, copies", ("elementwise", "vectorized",
                                         "unrolled", "reduce", "Reduce",
                                         "index", "gather", "scatter", "cat",
                                         "copy", "Copy", "fill", "Fill")),
)


def _kernel_group(name):
    return next((g for g, keys in KERNEL_GROUPS
                 if any(k in name for k in keys)), "other")


def _top(ms_by_name, n):
    return [[k[:96], v] for k, v in
            sorted(ms_by_name.items(), key=lambda kv: -kv[1])[:n]]


def phase_profile(est, window, masks):
    """One more main-path window under torch.profiler. Prints the share of
    the window's wall time in which the card ran no kernel, and the kernel
    time by group, by name and by stage of PoseNet.infer_window (its
    record_function spans: the kernels launched inside each span, and the
    span's extent on the device timeline, gaps included)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est.track_window(window[0], window[1], masks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    is_span = lambda e: (getattr(e, "is_user_annotation", False)
                         or e.name.startswith("infer_window."))
    kernels = [e for e in device if not is_span(e)]
    if not kernels:
        emit({"phase": "profile", "wall_ms": wall_ms,
              "device_time": "not measured: the profiler saw no kernel"})
        return
    busy_us, end = 0.0, -float("inf")
    for s, e in sorted((k.time_range.start, k.time_range.end)
                       for k in kernels):     # union of kernel intervals
        if e > end:
            busy_us += e - max(s, end)
            end = e
    by_name, groups = {}, {}
    for k in kernels:
        ms = k.time_range.elapsed_us() / 1e3
        by_name[k.name] = by_name.get(k.name, 0.0) + ms
        g = _kernel_group(k.name)
        groups[g] = groups.get(g, 0.0) + ms

    def launched_in(ev):                       # kernels of a CPU span's subtree
        out = list(ev.kernels)
        for ch in ev.cpu_children:
            out += launched_in(ch)
        return out

    stages = {}
    for ev in events:
        if ev.device_type == DeviceType.CPU and ev.name.startswith("infer_window."):
            ks = launched_in(ev)
            names = {}
            for k in ks:
                names[k.name] = names.get(k.name, 0.0) + k.duration / 1e3
            stages[ev.name] = {"kernel_ms": sum(names.values()),
                               "launches": len(ks), "top": _top(names, 4)}
    for e in device:
        if e.name in stages and is_span(e):
            stages[e.name]["device_span_ms"] = e.time_range.elapsed_us() / 1e3
    emit({"phase": "profile", "window": T_WINDOW, "wall_ms": wall_ms,
          "device_busy_ms": busy_us / 1e3,
          "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
          "kernel_launches": len(kernels), "stages": stages,
          "group_ms": groups, "top_kernels_ms": _top(by_name, 12)})


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = phase_device()
    kernels = phase_kernels(dev)
    phase_slice(dev)
    launches = phase_main(dev, smi)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    emit({"kernels": [{key: k[key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms")} for k in kernels]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
