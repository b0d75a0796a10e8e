"""Streaming tracking: windows of T frames through
``PoseEstimator.track_window``, each dispatched before the last one's poses
are read back, as a pipelined consumer of a camera does.

Mix keys: ``window`` (T), ``ahead`` (windows dispatched before the oldest
is read back), ``warmup_windows``, ``step_px`` and ``disparity_px`` (the
camera path, ``traffic.stream_frames``), ``max_fps`` (frames staged: enough
for this rate over the whole run; the run stops dispatching if the path
runs out), ``min_fps`` (the windows checked are drawn from those due at
this rate), ``check_windows`` and ``trace_windows``.
"""
from __future__ import annotations

import math
import time
from collections import deque

import numpy as np
import torch

from port_bench import compare, traffic
from port_bench.reference import searched_convolutions
from port_bench.reference.model import ident
from port_bench.reference.posenet import f2f_solve, f2f_window

REF_BLOCK = 6           # image pairs a block of the reference's RAFT


class Generator:
    def __init__(self, cell):
        self.cell = cell
        self.cfg, self.mix = cell.cfg, cell.mix
        self.dev = torch.device(cell.device)
        self.host = {}
        self.kept = {}          # window index -> the program's outputs
        self.read = []          # host poses of every window read, in order

    # set-up ----------------------------------------------------------------

    def setup(self, seconds: float, faults=None):
        """Inputs, the program, its first frame and warm-up windows;
        ``faults(self)`` may break the program before it runs (tests)."""
        from robust_pose_tpu_torch.slam.pose_estimator import PoseEstimator

        cfg, mix = self.cfg, self.mix
        H, W = cfg["image_shape"]
        T = mix["window"]
        self.T = T
        n_windows = math.ceil(mix["max_fps"] * seconds / T)
        self.n_windows = n_windows
        frames = 1 + T * (mix["warmup_windows"] + n_windows + mix["trace_windows"])
        self.left, self.right = traffic.stream_frames(
            self.cell.seed, frames, H, W, mix["step_px"], mix["disparity_px"],
            self.dev)
        self.weights = traffic.weights(self.cell.seed, cfg, self.dev)
        cam = cfg["camera"]
        self.K = traffic.intrinsics(cam, H, W, self.dev)
        slam = cfg["slam"]
        self.scale = 1.0 / slam["depth_clipping"][1]
        est = PoseEstimator(slam, self.K.cpu().numpy(), cam["baseline"],
                            {"state_dict": self.weights,
                             "config": {"model": dict(cfg["model"])}},
                            (W, H), device=self.dev)
        self.est = est
        if faults is not None:
            faults(self)
        infer = est.model.infer_window

        def capture(*a, **k):
            out = infer(*a, **k)
            if self._keep is not None:
                self.kept[self._keep] = out
            return out

        self._keep = None
        est.model.infer_window = capture
        self.masks = torch.ones((T, 1, H, W, 1), dtype=torch.bool, device=self.dev)
        one = torch.ones((1, H, W, 1), dtype=torch.bool, device=self.dev)
        est(self.left[:1], self.right[:1], one)
        self.next = 0            # the next window of the path
        for _ in range(mix["warmup_windows"]):
            self._read(self._dispatch(keep=False))
        # the windows checked: drawn from those due at min_fps
        due = max(1, int(mix["min_fps"] * seconds / T))
        rng = np.random.default_rng(self.cell.seed % (1 << 63))
        k = min(mix["check_windows"], due)
        self.sample = set((int(i) + mix["warmup_windows"])
                          for i in rng.choice(due, size=k, replace=False))

    def _frames(self, i):
        T = self.T
        s = slice(1 + T * i, 1 + T * (i + 1))
        return self.left[s][:, None], self.right[s][:, None]

    def _dispatch(self, keep=True):
        i = self.next
        self.next += 1
        self._keep = i if keep and i in self.sample else None
        l, r = self._frames(i)
        t0 = time.perf_counter()
        poses, succ = self.est.track_window(l, r, self.masks)
        return i, t0, time.perf_counter() - t0, poses, succ

    def _read(self, item):
        i, t0, _, poses, succ = item
        p, s = poses.cpu(), succ.cpu()
        self.read.append((i, p, s))
        return time.perf_counter() - t0

    # the measured window ---------------------------------------------------

    def _available(self):
        return self.next < self.mix["warmup_windows"] + self.n_windows

    def window(self, seconds: float) -> dict:
        """The timed run: track_fps over every frame read back, and the 95th
        percentile of the windows' latency from dispatch to poses on the
        host."""
        ahead = self.mix["ahead"]
        pending, lat, disp = deque(), [], []
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds and self._available():
            item = self._dispatch()
            disp.append(item[2])
            pending.append(item)
            while len(pending) > ahead:
                lat.append(self._read(pending.popleft()))
        while pending:
            lat.append(self._read(pending.popleft()))
        wall = time.perf_counter() - t_start
        if not self._available():
            print("port_bench: the camera path ran out before the window "
                  "closed", flush=True)
        self.host["dispatch_s"] = disp
        self.host["latency_s"] = lat
        self.attempted = len(lat)
        self.rate = self.T * len(lat) / wall
        return {"track_fps": self.rate,
                "window_p95_ms": 1e3 * float(np.percentile(lat, 95))}

    def trace_fn(self):
        """The traced slice: ``trace_windows`` more windows of the path,
        dispatched and read as in the window."""
        def run():
            pending = deque()
            for _ in range(self.mix["trace_windows"]):
                pending.append(self._dispatch(keep=False))
                while len(pending) > self.mix["ahead"]:
                    self._read(pending.popleft())
            while pending:
                self._read(pending.popleft())
            return self.mix["trace_windows"]
        return run

    def work(self) -> dict:
        """One window's work for the analytic counts: 2T RAFT pairs (T
        temporal, T stereo), 2T images through the feature encoder, T
        through the context encoder, T pairs of heads."""
        T = self.T
        return {"pairs": 2 * T, "fnet": 2 * T, "cnet": T, "heads": T,
                "backward": False, "per_rate": T}

    # correctness -----------------------------------------------------------

    def release(self):
        """Free the program; keep its outputs of the windows checked."""
        est = self.est
        poses = {i: (p, s) for i, p, s in self.read}
        order = [i for i, _, _ in self.read]
        self.checked = []
        for i, out in sorted(self.kept.items()):
            if i not in poses:
                continue
            prev = order[order.index(i) - 1]
            self.checked.append({
                "window": i, "start": poses[prev][0][-1].to(self.dev),
                "out": {"time_flow": out.flow, "stereo_flow": out.stereo_flow2,
                        "depth": out.depth2, "depth1": out.depth1,
                        "conf1": out.conf1,
                        "conf2": out.conf2, "pose": out.pose,
                        "success": poses[i][1].to(self.dev),
                        "poses": poses[i][0][:, 0].to(self.dev)}})
        self.kept.clear()
        self.est = est.model = None
        del est
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _rcfg(self):
        m = self.cfg["model"]
        return {"iters": m["iters"], "unet_levels": m.get("unet_levels", 3),
                "lm_iters": self.cfg["slam"]["lbgfs_iters"]}

    def _baseline(self):
        return torch.tensor([float(self.cfg["camera"]["baseline"])],
                            device=self.dev)

    def reference(self, item, q=ident):
        T = self.T
        i = item["window"]
        g0 = T * i
        rcfg = self._rcfg()
        with searched_convolutions():
            return f2f_window(
                self.weights, rcfg, self.left[g0:g0 + 1], self.right[g0:g0 + 1],
                self.left[g0 + 1:g0 + T + 1], self.right[g0 + 1:g0 + T + 1],
                self.K[None], self._baseline(), self.scale, item["start"],
                block=REF_BLOCK, q=q)

    def solve(self, item, build=torch.float32):
        """The reference's pose solve on the program's own flows, depths and
        confidences of a window checked, its normal equations built in
        ``build``."""
        o = item["out"]
        nchw = lambda x: x.permute(0, 3, 1, 2)
        return f2f_solve(self.weights, self._rcfg(), *(nchw(o[k]) for k in (
            "time_flow", "stereo_flow", "depth1", "depth", "conf1", "conf2")),
            self.K[None], self._baseline(), self.scale, build)

    def numbers(self, item, ref) -> dict:
        """One window checked against the reference's window ``ref``, and
        the program's solve against the reference's on the same inputs."""
        return dict(compare.window_numbers(item["out"], ref, item["start"],
                                           self.scale),
                    solve_pose=compare.solve_gap(item["out"]["pose"],
                                                 self.solve(item)))

    def check(self) -> dict:
        """The worst of each number over the windows checked."""
        return compare.worst(self.numbers(it, self.reference(it))
                             for it in self.checked)
