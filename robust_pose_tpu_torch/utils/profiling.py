"""Profiling hooks (port of ``robust_pose_tpu/utils/profiling.py``):
``trace(logdir)`` captures a torch.profiler trace of a region (host and
CUDA activity, written as a Chrome trace), and ``StageTimer`` keeps
host-side per-stage wall time for the inference loop.

``span(name)`` names a stage of a path: a ``record_function`` range that
torch.profiler shows, and the span ``utils.costs`` files the FLOPs and
bytes of the enclosed work under. ``profile_run`` runs a callable under
torch.profiler on the card and gives its busy and idle time, the kernel
time by group (``KERNEL_GROUPS``), by name and by span;
``device_events`` gives the device records of repeated calls (kernels,
copies, memsets), retaking a trace that lost some. ``span_rates`` joins a
profiled run's spans to a counted run's: the achieved GB/s and TFLOP/s of
each span. The scripts ``profile_trace``, ``profile_stages`` and
``profile_f2m`` are command lines over these.

The JAX module's ``enable_compile_cache`` has no counterpart: PyTorch runs
eagerly and compiles no program to cache (the port's hand-written kernels
are built once per source hash under ``build/``, see ``ops/_build.py``).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List

import torch
from torch.profiler import record_function

_spans: List[str] = []        # the spans open, innermost last


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """A named stage: a torch.profiler ``record_function`` range, and the
    span ``utils.costs`` counts the enclosed work under. Outside a profiler
    and a counter it costs a few microseconds."""
    _spans.append(name)
    try:
        with record_function(name):
            yield
    finally:
        _spans.pop()


def current_span():
    """The innermost open span's name, or None."""
    return _spans[-1] if _spans else None


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


# ---------------------------------------------------------------------------
# the card's timeline (torch.profiler)
# ---------------------------------------------------------------------------

PROFILER_MARKS = 8            # marker kernels that open a device_events trace
profiler_retries = 0          # device_events traces retaken (events lost)


def _runtime_launch(e) -> bool:
    """A host-side CUDA runtime or driver record of a kernel launch, a copy
    or a memset: one device event each."""
    from torch.autograd import DeviceType

    return (e.device_type != DeviceType.CUDA
            and any(k in e.name for k in ("Launch", "Memcpy", "Memset")))


def device_events(fn, reps: int = 10, per_call=None):
    """The device events (kernels, copies, memsets) of ``reps`` calls of
    fn() in one torch.profiler trace, in the order they started. On the
    H100 machines this was measured on, a trace drops its first device
    records (nearly always one, now and then dozens) and at times one
    more: so a trace opens with marker kernels (``torch.cuda._sleep``,
    synchronised, then left out), and it is kept only when its device
    events number what was launched: ``per_call`` a call where the caller
    knows it, else the launches, copies and memsets that the host side of
    the same trace recorded (where that side misses some, two traces with
    the same count). Otherwise it is taken again with twice the markers,
    after a pause, eight times at most, each retry counted in
    ``profiler_retries``."""
    global profiler_retries
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    marks = PROFILER_MARKS
    fullest = None           # where the host side recorded too few launches
    for _ in range(8):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(marks):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        ev = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and "spin_kernel" not in e.name]
        launched = sum(1 for e in events if _runtime_launch(e)) - marks
        if per_call is not None:
            want = per_call * reps
        elif len(ev) <= launched:
            want = launched
        else:                # no host record of some launch: two traces alike
            want, fullest = fullest, max(fullest or 0, len(ev))
        if ev and len(ev) == want:
            return sorted(ev, key=lambda e: e.time_range.start)
        profiler_retries += 1
        marks *= 2
        time.sleep(1.0)
    raise RuntimeError(f"the profiler lost device events in 8 traces "
                       f"({len(ev)} events for {want} launched by {reps} calls "
                       f"in the last)")


KERNEL_GROUPS = (            # (group, substrings of the device kernel name)
    ("corr_window_lookup (K1)", ("corr_window",)),
    ("instance_norm (K2)", ("instance_norm_",)),
    ("normal_eq (K3)", ("normal_eq",)),
    ("lanewise_lookup (K4)", ("lanewise_fwd",)),
    ("lanewise_lookup_bwd (K5)", ("lanewise_bwd",)),
    ("pixel_lookup (K6)", ("pixel_lookup",)),
    ("grouped_lookup (K7)", ("grouped_lookup",)),
    ("memsets", ("Memset",)),
    ("convolutions and products", ("conv", "cudnn", "xmma", "gemm", "sm90_",
                                   "cutlass", "implicit")),
    ("elementwise, reductions, copies", ("elementwise", "vectorized",
                                         "unrolled", "reduce", "Reduce",
                                         "index", "gather", "scatter", "cat",
                                         "copy", "Copy", "fill", "Fill")),
)


def kernel_group(name: str) -> str:
    """The ``KERNEL_GROUPS`` group of a device kernel's name, or "other"."""
    return next((g for g, keys in KERNEL_GROUPS
                 if any(k in name for k in keys)), "other")


def top_ms(ms_by_name: Dict[str, float], n: int):
    """The ``n`` largest [name (96 characters), ms] rows."""
    return [[k[:96], v] for k, v in
            sorted(ms_by_name.items(), key=lambda kv: -kv[1])[:n]]


def profile_run(run, span_prefix, top: int = 12):
    """``run()`` under torch.profiler: the share of its wall time in which
    the card ran no kernel, and the kernel time by group, by name and by
    stage. A stage is a ``span`` named ``span_prefix*`` (a str or a tuple
    of them); the work runs on one stream in order, so a stage's device
    window reaches from the start of its span on the device timeline to
    the start of the next span, and every kernel that starts in it
    (hand-written ones and those of the autograd thread included) counts
    for the stage; a stage's host ms are its spans' own on the host
    clock. ``top``: the kernels listed by their summed time. If the
    profiler saw no kernel, only the wall time, with the device time
    marked "not measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    is_span = lambda e: (getattr(e, "is_user_annotation", False)
                         or e.name.startswith(span_prefix))
    kernels = [e for e in device if not is_span(e)]
    if not kernels:
        return {"wall_ms": wall_ms,
                "device_time": "not measured: the profiler saw no kernel"}
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
        g = kernel_group(k.name)
        groups[g] = groups.get(g, 0.0) + ms
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in device if is_span(e) and e.name.startswith(span_prefix))
    stages = {}
    for i, (s0, e0, name) in enumerate(spans):
        s1 = spans[i + 1][0] if i + 1 < len(spans) else e0
        st = stages.setdefault(name, {"device_ms": 0.0, "kernel_ms": 0.0,
                                      "host_ms": 0.0, "launches": 0,
                                      "in_span_launches": 0, "names": {}})
        st["device_ms"] += (s1 - s0) / 1e3
        for k in kernels:
            if s0 <= k.time_range.start < s1:
                ms = k.time_range.elapsed_us() / 1e3
                st["kernel_ms"] += ms
                st["launches"] += 1
                st["in_span_launches"] += k.time_range.start <= e0
                st["names"][k.name] = st["names"].get(k.name, 0.0) + ms
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in stages:
            stages[e.name]["host_ms"] += e.time_range.elapsed_us() / 1e3
    for st in stages.values():
        st["top"] = top_ms(st.pop("names"), 4)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "kernel_launches": len(kernels), "stages": stages,
            "group_ms": groups, "top_kernels_ms": top_ms(by_name, top)}


def card_device(tool: str, device=None) -> torch.device:
    """The CUDA device a profile tool runs on (``cuda`` unless named);
    raises for any other, since no CPU time may stand in for the card's."""
    from robust_pose_tpu_torch.device import resolve_device

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError(f"{tool} reads the card's timeline: it needs a CUDA "
                           f"device, and prints no device time for {device}")
    return device


def card(device) -> Dict[str, object]:
    """The card a measurement was taken on, as ``nvidia-smi
    --query-gpu=name,power.limit`` gives them (its power limit sets its
    speed under load); both None for a device other than CUDA."""
    import subprocess

    if torch.device(device).type != "cuda":
        return {"device": None, "power_limit": None}
    idx = torch.device(device).index or 0
    out = subprocess.run(
        ["nvidia-smi", f"--id={idx}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    name, limit = (x.strip() for x in out.split(",", 1))
    return {"device": name, "power_limit": limit}


def span_rates(prof: dict, counter) -> Dict[str, dict]:
    """Each stage of ``prof`` (``profile_run``) with the counted work of the
    same span in ``counter`` (``utils.costs``, a run of the same inputs):
    the span's GB and GFLOP, and its achieved GB/s and TFLOP/s over the
    stage's device ms. A span the counter did not see gets none."""
    out = {}
    for name, st in prof.get("stages", {}).items():
        fl, nb = counter.by_span.get(name, (None, None))
        row = {"device_ms": st["device_ms"], "kernel_ms": st["kernel_ms"],
               "host_ms": st["host_ms"], "launches": st["launches"]}
        if fl is not None:
            sec = st["device_ms"] / 1e3
            row.update({"gb": nb / 1e9, "gflop": fl / 1e9,
                        "achieved_gb_per_s": nb / 1e9 / sec if sec else None,
                        "achieved_tflop_per_s": fl / 1e12 / sec if sec else None})
        out[name] = row
    return out
