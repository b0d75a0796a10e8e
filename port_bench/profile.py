"""A traced slice of a run and what the per-layer metrics read from it.

``capture(fn)`` runs ``fn()`` (a few windows or steps of the cell's own
work) under torch.profiler with host and CUDA activity. The slice is the
host range ``port_bench.slice`` around ``fn()`` and a synchronize, so its
length covers the device work it issued. torch.profiler drops the first
device records of a trace on the machines this was measured on, so the
trace opens with marker kernels (``torch.cuda._sleep``, synchronised and
left out). Nothing is written to disk.

The reduction follows the program's ``utils/profiling.profile_run``: busy
time is the union of kernel intervals in the slice; a span's device
window reaches from its start on the device timeline to the start of the
next span, and the kernels that start in it are its kernels.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

MARKS = 8
SLICE = "port_bench.slice"


@dataclass
class Slice:
    start: float                    # us, profiler clock
    end: float
    units: int                      # windows or steps in the slice
    kernels: List[Tuple[str, float, float]]         # (name, start, end)
    spans: List[Tuple[str, float, float]]           # device annotations
    host: List[Tuple[str, float, float]] = field(repr=False)  # host events

    @property
    def wall_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_s(self) -> float:
        busy, reach = 0.0, -float("inf")
        for s, e in sorted((max(s, self.start), min(e, self.end))
                           for _, s, e in self.kernels):
            if e <= s:
                continue
            if e > reach:
                busy += e - max(s, reach)
                reach = e
        return busy / 1e6

    def kernel_s(self, *keys: str) -> float:
        """Summed duration of the kernels whose name holds one of ``keys``."""
        return sum(e - s for n, s, e in self.kernels
                   if any(k in n for k in keys)) / 1e6

    def span_kernel_s(self, name: str) -> Optional[float]:
        """Kernel seconds in the device windows of span ``name``; None
        where the trace holds no such span."""
        spans = sorted(self.spans, key=lambda x: x[1])
        wins = [(s, spans[i + 1][1] if i + 1 < len(spans) else e)
                for i, (n, s, e) in enumerate(spans) if n == name]
        if not wins:
            return None
        return sum(ke - ks for _, ks, ke in self.kernels
                   if any(s <= ks < e for s, e in wins)) / 1e6

    def top_ops(self, n: int = 10):
        by: Dict[str, float] = {}
        for k, s, e in self.kernels:
            by[k[:96]] = by.get(k[:96], 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10):
        """The ``n`` longest intervals of the slice with no kernel running,
        each named by the innermost host range open where it begins."""
        gaps, reach = [], self.start
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            if s > reach:
                gaps.append((s - reach, reach))
            reach = max(reach, e)
        if self.end > reach:
            gaps.append((self.end - reach, reach))
        gaps.sort(reverse=True)
        out = []
        for dur, at in gaps[:n]:
            inner = [(e - s, name) for name, s, e in self.host
                     if s <= at < e and name != SLICE]
            out.append([min(inner)[1] if inner else "host idle", dur / 1e6])
        return out


def capture(fn: Callable[[], int]) -> Slice:
    """Trace ``fn()``, which returns the number of units it ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(MARKS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        time.sleep(0.01)
        with record_function(SLICE):
            units = fn()
            torch.cuda.synchronize()
    kernels, spans, host = [], [], []
    start = end = None
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                spans.append((e.name, tr.start, tr.end))
            elif "spin_kernel" not in e.name:
                kernels.append((e.name, tr.start, tr.end))
        else:
            if e.name == SLICE:
                start, end = tr.start, tr.end
            host.append((e.name, tr.start, tr.end))
    if start is None:
        raise RuntimeError("the trace holds no slice range")
    kernels = [k for k in kernels if k[1] >= start]
    spans = [s for s in spans if s[1] >= start and s[0] != SLICE]
    return Slice(start, end, units, kernels, spans, host)
