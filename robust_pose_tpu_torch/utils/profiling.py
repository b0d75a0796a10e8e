"""Profiling hooks (port of ``robust_pose_tpu/utils/profiling.py``):
``trace(logdir)`` captures a torch.profiler trace of a region (host and
CUDA activity, written as a Chrome trace), and ``StageTimer`` keeps
host-side per-stage wall time for the inference loop.

The JAX module's ``enable_compile_cache`` has no counterpart: PyTorch runs
eagerly and compiles no program to cache (the port's hand-written kernels
are built once per source hash under ``build/``, see ``ops/_build.py``).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a torch.profiler trace of the enclosed region into
    ``logdir/trace.json`` (CUDA activity too when a card is present)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _synchronize(sync) -> None:
    """Wait for the device work behind ``sync`` (a tensor, or a nested
    list / tuple / dict of them): a CUDA synchronize on each CUDA device
    it touches; CPU tensors are ready already."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(sync)
    for d in devices:
        torch.cuda.synchronize(d)


class StageTimer:
    """Accumulates per-stage wall time; ``summary()`` returns mean ms."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None) -> Iterator[None]:
        """Time a stage; pass ``sync=tensors`` to wait for their device
        work before the clock stops."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            _synchronize(sync)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return {k: 1000.0 * self.totals[k] / max(self.counts[k], 1)
                for k in self.totals}

    def report(self) -> str:
        return "  ".join(f"{k}: {v:.1f}ms" for k, v in self.summary().items())
