"""Profiling hooks (port of ``robust_pose_tpu/utils/profiling.py``).

``span(name)`` names a stage of a path, and is the port's one tracing
system. Every call of a span records, on the host clock
(``time.perf_counter_ns``), when it opened, how long it was open, the host
syncs counted while it was open and whether a torch.profiler was active
when it opened (``SpanRecord``): the last ``RING`` calls by name, beside a
count and a total of every call (``span_records``, ``span_totals``;
``reset`` forgets them). While a torch.profiler is active a span is also a
``record_function`` range the trace shows; with the profiler off it costs
two clock reads and a ring append. ``utils.costs`` files the FLOPs and
bytes of the work under the innermost open span (``current_span``).
``host_read(x)`` is the one way the program's paths read a device value
to the host: it counts one host sync against every span open, as
``new_tensor`` does for a host list copied to the device and
``count_sync()`` for any other op that waits for the device on its own.
``on_trace`` puts records on a torch.profiler trace's timeline.
``StageTimer`` gives the CLIs' per-stage wall time, read from their spans
``cli.<stage>``.

``profile_run`` runs a callable under torch.profiler on the card and
gives its busy and idle time, the kernel time by group
(``KERNEL_GROUPS``), by name and by span;
``device_events`` gives the device records of repeated calls (kernels,
copies, memsets), retaking a trace that lost some. ``span_rates`` joins a
profiled run's spans to a counted run's: the achieved GB/s and TFLOP/s of
each span. The scripts ``profile_trace``, ``profile_stages`` and
``profile_f2m`` are command lines over these. ``chained_row`` times one
op by K chained calls (device ms, host slope, launches and counted
bytes): the rows of the probes ``profile_{device,winner_prims,scatter,
warp4,render_decomp}``.

The JAX module's ``enable_compile_cache`` has no counterpart: PyTorch runs
eagerly and compiles no program to cache (the port's hand-written kernels
are built once per source hash under ``build/``, see ``ops/_build.py``).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Iterator, List, NamedTuple, Tuple

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

RING = 4096                   # the calls of a span whose records are kept


class SpanRecord(NamedTuple):
    start_ns: int             # time.perf_counter_ns() when the span opened
    ns: int                   # how long it was open, host ns
    syncs: int                # host syncs counted while it was open
    traced: bool              # a torch.profiler was active when it opened


class _Stats:
    __slots__ = ("calls", "total_ns", "ring")

    def __init__(self):
        self.calls, self.total_ns, self.ring = 0, 0, deque(maxlen=RING)


_spans: List[str] = []        # the spans open, innermost last (all threads)
_stats: Dict[str, _Stats] = {}
host_syncs = 0                # host syncs counted in this process


class span:
    """A named stage: its host time and host syncs recorded on every call,
    a torch.profiler ``record_function`` range while a profiler is active,
    and the span ``utils.costs`` counts the enclosed work under."""

    __slots__ = ("name", "_range", "_t0", "_s0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        _spans.append(self.name)
        self._range = None
        if _profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        self._s0 = host_syncs
        self._t0 = time.perf_counter_ns()

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(*exc)
        ns = time.perf_counter_ns() - self._t0
        syncs = host_syncs - self._s0
        _spans.pop()
        st = _stats.get(self.name)
        if st is None:
            st = _stats[self.name] = _Stats()
        st.calls += 1
        st.total_ns += ns
        st.ring.append((self._t0, ns, syncs, self._range is not None))


def current_span():
    """The innermost open span's name, or None."""
    return _spans[-1] if _spans else None


def count_sync() -> None:
    """Count one host sync against every span open: for an op that waits
    for the device on its own, beside the op."""
    global host_syncs
    host_syncs += 1


def host_read(x: torch.Tensor):
    """``x``'s value on the host (``x.tolist()``: a Python number for a 0-d
    tensor), one host sync counted against every span open."""
    count_sync()
    return x.tolist()


def new_tensor(like: torch.Tensor, data) -> torch.Tensor:
    """``like.new_tensor(data)``, host data copied to ``like``'s device: on
    a CUDA device the copy from pageable memory waits for the stream, one
    host sync counted against every span open (on the CPU too, as
    ``host_read`` counts its reads)."""
    count_sync()
    return like.new_tensor(data)


def span_records(name: str) -> List[SpanRecord]:
    """The last ``RING`` calls of span ``name``, oldest first."""
    st = _stats.get(name)
    return [] if st is None else [SpanRecord(*r) for r in st.ring]


def span_totals(name: str) -> Tuple[int, int]:
    """(calls, host ns) of every call of span ``name`` since ``reset``."""
    st = _stats.get(name)
    return (0, 0) if st is None else (st.calls, st.total_ns)


def reset() -> None:
    """Forget every span's records and totals and the sync count."""
    global host_syncs
    _stats.clear()
    host_syncs = 0


def on_trace(records: Iterable[SpanRecord], prof) -> List[Tuple[float, float]]:
    """Each record's (start, end) on the timeline of ``prof``, a finished
    torch.profiler ``profile``, in the us of its events' ``time_range``:
    the trace's events count from its start on the wall clock
    (``trace_start_ns``), the records on ``perf_counter_ns``, so a record
    moves by the two clocks' offset, read now. An idle gap of the trace
    can then be put down to the span the host was in."""
    offset = (time.time_ns() - time.perf_counter_ns()
              - prof.profiler.kineto_results.trace_start_ns())
    return [((r.start_ns + offset) / 1e3, (r.start_ns + r.ns + offset) / 1e3)
            for r in records]


def _synchronize(sync) -> None:
    """Wait for the device work behind ``sync`` (a tensor, or a nested
    list / tuple / dict of them): a CUDA synchronize on each CUDA device
    it touches, each counted as a host sync; CPU tensors are ready
    already."""
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
        count_sync()
        torch.cuda.synchronize(d)


class StageTimer:
    """Per-stage wall time of a loop: stage ``name`` is the span
    ``cli.<name>``, and ``totals`` (s), ``counts`` and ``summary()`` (mean
    ms) read that span's calls from this timer's first run of the stage
    on."""

    def __init__(self):
        # each stage's span totals before its first run, first run first
        self._base: Dict[str, Tuple[int, int]] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None) -> Iterator[None]:
        """Time a stage; pass ``sync=tensors`` to wait for their device
        work before the clock stops."""
        if name not in self._base:
            self._base[name] = span_totals(f"cli.{name}")
        with span(f"cli.{name}"):
            yield
            if sync is not None:
                _synchronize(sync)

    def _since(self, name: str) -> Tuple[int, int]:
        calls, ns = span_totals(f"cli.{name}")
        calls0, ns0 = self._base[name]
        return calls - calls0, ns - ns0

    @property
    def totals(self) -> Dict[str, float]:
        return defaultdict(float,
                           {k: self._since(k)[1] / 1e9 for k in self._base})

    @property
    def counts(self) -> Dict[str, int]:
        return defaultdict(int, {k: self._since(k)[0] for k in self._base})

    def summary(self) -> Dict[str, float]:
        totals, counts = self.totals, self.counts
        return {k: 1000.0 * totals[k] / max(counts[k], 1) for k in self._base}

    def report(self) -> str:
        return "  ".join(f"{k}: {v:.1f}ms" for k, v in self.summary().items())


# ---------------------------------------------------------------------------
# the card's timeline (torch.profiler)
# ---------------------------------------------------------------------------

PROFILER_MARKS = 8            # marker kernels that open a device_events trace
profiler_retries = 0          # device_events traces retaken (events lost)
_marks = PROFILER_MARKS       # the markers that opened the last trace kept


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
    ``profiler_retries``. A trace opens with as many markers as the last
    one kept: late in a long process a first take with 8 lost events
    nearly every time."""
    global profiler_retries, _marks
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    marks = _marks
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
            _marks = marks
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


# ---------------------------------------------------------------------------
# chained calls: the probes' rows (scripts/profile_{device,winner_prims,...})
# ---------------------------------------------------------------------------

def chain_scalar(out) -> torch.Tensor:
    """A 0-d False that depends on ``out``: its first tensor's first
    element compared equal to NaN (one launch; False whatever the
    element, NaN and infinities included)."""
    from torch.utils._pytree import tree_flatten

    leaf = next(t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor))
    return leaf[(0,) * leaf.ndim].eq(float("nan"))


def chain_into(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``x`` with the chain scalar ``c`` added in place to its first
    element (one launch; x keeps its bits, c being False): the input of a
    chained call that depends on the last call's output."""
    x[(0,) * x.ndim].add_(c)
    return x


def chained(fn, inputs, k: int) -> torch.Tensor:
    """``k`` calls ``fn(c, *inputs[i % len(inputs)])``, each given the
    chain scalar of the last one's output (False for the first); returns
    the last call's scalar."""
    c = torch.zeros((), dtype=torch.bool, device=_device_of(inputs))
    for i in range(k):
        c = chain_scalar(fn(c, *inputs[i % len(inputs)]))
    return c


def _device_of(inputs) -> torch.device:
    from torch.utils._pytree import tree_flatten

    return next(t.device for t in tree_flatten(inputs)[0]
                if isinstance(t, torch.Tensor))


def chained_row(name: str, fn, inputs, k1: int, k2: int, reps: int = 3) -> dict:
    """One probe row: ``fn(c, *xs)`` runs the op once on inputs ``xs``
    (one tuple of ``inputs``, taken in turn) and feeds ``c``, the last
    call's chain scalar, into one input through :func:`chain_into`.

    - ``device_ms``: the summed duration of the device events of ``k2``
      chained calls in one torch.profiler trace (``device_events``) over
      k2; ``launches``: those events over k2 (the chain's two launches
      a call included);
    - ``host_slope_ms``: (t(k2) - t(k1)) / (k2 - k1), t(k) the median over
      ``reps`` of the host clock around k chained calls and a
      synchronize: what a call costs whichever of the host and the card
      sets the pace, with the fixed costs cancelled; ``host_bound`` where
      it exceeds ``device_ms``;
    - ``bytes``: what ``utils.costs`` counts for one call (aten operands
      and outputs, the hand kernels' formulas), and ``gb_per_s`` over
      ``device_ms``. The counter counts L2 hits as traffic, so the rate
      can read above the device memory's;
    - ``wall_s``: the host seconds the row took, ``profiler_s`` of them in
      its trace, and the trace's ``profiler_retries``."""
    from robust_pose_tpu_torch.utils import costs

    t_row, retries = time.perf_counter(), profiler_retries
    with torch.no_grad():
        chained(fn, inputs, 1)
        with costs.count() as counter:
            fn(torch.zeros((), dtype=torch.bool, device=_device_of(inputs)),
               *inputs[0])
        host = {}
        for k in (k1, k2):
            ts = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                chained(fn, inputs, k)
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
            host[k] = sorted(ts)[len(ts) // 2] * 1e3
        t_prof = time.perf_counter()
        ev = device_events(lambda: chained(fn, inputs, k2), reps=1)
        t_prof = time.perf_counter() - t_prof
    dev_ms = sum(e.time_range.elapsed_us() for e in ev) / k2 / 1e3
    slope = (host[k2] - host[k1]) / (k2 - k1)
    return {"name": name, "device_ms": dev_ms, "host_slope_ms": slope,
            "host_ms": {f"k{k1}": host[k1], f"k{k2}": host[k2]},
            "launches": len(ev) / k2, "bytes": counter.bytes,
            "gb_per_s": counter.bytes / dev_ms / 1e6 if dev_ms > 0 else None,
            "host_bound": slope > dev_ms, "wall_s": time.perf_counter() - t_row,
            "profiler_s": t_prof, "profiler_retries": profiler_retries - retries}


def chained_rows(specs, k1: int, k2: int) -> List[dict]:
    """The ``chained_row`` of each (name, fn, inputs) of ``specs``, each
    printed (``row_line``) as it comes."""
    rows = []
    for name, fn, inputs in specs:
        rows.append(chained_row(name, fn, inputs, k1, k2))
        print(row_line(rows[-1]), flush=True)
    return rows


def row_line(row: dict) -> str:
    """A probe row as one printed line."""
    gbs = row["gb_per_s"]
    return (f"{row['name']:58s} {row['device_ms']:9.4f} device ms "
            f"{row['host_slope_ms']:9.4f} host ms/call "
            f"{row['launches']:7.1f} launches "
            f"{'-' if gbs is None else f'{gbs:8.1f}'} GB/s"
            + ("  host-bound" if row["host_bound"] else ""))


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
