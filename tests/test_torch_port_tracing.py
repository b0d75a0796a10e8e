"""The program's span recorder (``utils/profiling``): each call of a span
keeps its host ns, the host syncs counted while it was open and whether a
torch.profiler traced it; ``host_read`` counts against every open span;
the tracker's and the trainer's spans at 64x96 on the CPU; the CLIs'
stages as spans ``cli.*``; ``utils.costs`` still files the autograd
thread's work under ``train_step.backward``.

The card tests (``-m card``) hold the counter to every sync of an f2f
window (none) and a training step (the clip test's) under
``torch.cuda.set_sync_debug_mode``, the records to their ranges in a
trace, and the host's lead: a window queued behind a sleep kernel returns
before the sleep ends. This file imports no JAX, so on a
machine without it the card test runs apart from the suite's conftest:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_port_tracing.py -m card``.
"""
import time
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from robust_pose_tpu_torch.scripts import bench
from robust_pose_tpu_torch.train.trainer import PoseNetTrainer
from robust_pose_tpu_torch.utils import costs, profiling
from robust_pose_tpu_torch.utils.profiling import (
    StageTimer,
    host_read,
    span,
    span_records,
    span_totals,
)

H, W, T = 64, 96, 2
WINDOW_SPANS = ("track_window", "track_window.chain", "infer_window.encode",
                "infer_window.flow", "infer_window.weights", "infer_window.solve")


@pytest.fixture(autouse=True)
def fresh():
    """Every test starts from an empty recorder, on two threads."""
    profiling.reset()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    profiling.reset()


@pytest.fixture()
def card():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with python -m pytest "
                    "--noconftest tests/test_torch_port_tracing.py -m card")
    return torch.device("cuda", 0)


def _estimator(monkeypatch, device, iters=2, t=T):
    """The bench's f2f estimator at 64x96 (one UNet level: the 3-level
    TinyUNet needs ~384x512) with ``iters`` GRU iterations, its first frame
    given; returns it, the windows of ``t`` frames staged and their
    masks."""
    monkeypatch.setattr(bench, "H", H)
    monkeypatch.setattr(bench, "W", W)
    monkeypatch.setattr(bench, "MODEL", dict(bench.MODEL, iters=iters, unet_levels=1))
    est = bench.build_estimator(dict(bench.F2F_SLAM), device=device)
    windows, masks = bench.start_stream(est, t, 3)
    return est, windows, masks


def _trainer(device, batch=2):
    """A trainer at 64x96 (RAFT's gradients live, the LM's early exit on)
    and a batch made on ``device``."""
    from robust_pose_tpu_torch.scripts import bench_train_step as bts

    cfg = {"model": {"iters": 2, "lbgfs_iters": 20, "use_weights": True,
                     "unet_levels": 1, "dropout": 0.0, "small": False},
           "image_shape": [H, W],
           "train": {"batch_size": batch, "learning_rate": 1e-5,
                     "weight_decay": 5e-5, "epsilon": 1e-8, "grad_clip": 1.0,
                     "freeze_flow_steps": 10 ** 18}}
    trainer = PoseNetTrainer(cfg, device=device)
    state = trainer.init_state(seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bts, "H", H)
        mp.setattr(bts, "W", W)
        data = bts.make_batch(batch, key=1, device=device)
    return trainer, state, data


# --- the recorder ------------------------------------------------------------

def test_nested_spans_record_their_durations_and_counts():
    for _ in range(3):
        t0 = time.perf_counter_ns()
        with span("outer"):
            time.sleep(0.002)
            with span("inner"):
                time.sleep(0.003)
        wall = time.perf_counter_ns() - t0
    outer, inner = span_records("outer"), span_records("inner")
    assert len(outer) == len(inner) == 3
    for o, i in zip(outer, inner):
        assert o.start_ns < i.start_ns and i.start_ns + i.ns <= o.start_ns + o.ns
        assert i.ns >= 3_000_000 and o.ns >= i.ns + 2_000_000
        assert not o.traced and o.syncs == 0
    assert o.ns <= wall
    calls, total = span_totals("outer")
    assert calls == 3 and total == sum(r.ns for r in outer)
    assert span_totals("never") == (0, 0) and span_records("never") == []
    assert profiling.current_span() is None


def test_the_ring_keeps_the_last_calls_and_counts_every_one():
    n = profiling.RING + 10
    for i in range(n):
        with span("busy"):
            if i >= 10:
                profiling.count_sync()
    recs = span_records("busy")
    assert len(recs) == profiling.RING
    assert all(r.syncs == 1 for r in recs)     # the first 10 fell out
    assert span_totals("busy")[0] == n
    assert recs == sorted(recs, key=lambda r: r.start_ns)


def test_traced_flag_and_ranges_under_a_cpu_profiler():
    with span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with span("outer"):
                with span("inner"):
                    torch.ones(64).sum()
    with span("after"):
        pass
    assert [r.traced for r in span_records("before") + span_records("after")] == [
        False, False]
    assert all(r.traced for r in span_records("outer") + span_records("inner"))
    ranges = {n: sorted(e.time_range.start for e in prof.events() if e.name == n)
              for n in ("outer", "inner", "before", "after")}
    assert len(ranges["outer"]) == len(ranges["inner"]) == 3
    assert ranges["before"] == ranges["after"] == []
    # each record on the trace's timeline opens inside its own range
    events = sorted((e for e in prof.events() if e.name == "inner"),
                    key=lambda e: e.time_range.start)
    for (s, e), ev in zip(profiling.on_trace(span_records("inner"), prof), events):
        assert ev.time_range.start - 2e3 < s < e < ev.time_range.end + 2e3


def test_host_reads_and_copies_count_against_every_open_span():
    x = torch.tensor([3, 4], dtype=torch.int32)
    with span("a"):
        assert host_read(torch.tensor(True)) is True
        with span("b"):
            assert host_read(x) == [3, 4]
            assert host_read(x.sum()) == 7
        profiling.count_sync()
        profiling.count_sync()
        y = profiling.new_tensor(x, [1.0, 2.0])
    with span("c"):
        pass
    (a,), (b,), (c,) = (span_records(n) for n in "abc")
    assert (a.syncs, b.syncs, c.syncs) == (6, 2, 0)
    assert profiling.host_syncs == 6
    assert y.tolist() == [1, 2] and y.dtype == x.dtype


# --- the program's spans -------------------------------------------------------

def test_track_window_records_its_spans_once_a_window(monkeypatch):
    est, windows, masks = _estimator(monkeypatch, "cpu")
    profiling.reset()
    poses, succ = est.track_window(windows[1][0], windows[1][1], masks)
    assert poses.shape == (T, 1, 7) and succ.shape == (T,)
    recs = {n: span_records(n) for n in WINDOW_SPANS}
    assert all(len(r) == 1 for r in recs.values()), {n: len(r) for n, r in recs.items()}
    (window,), (chain,), (flow,) = (recs[n] for n in (
        "track_window", "track_window.chain", "infer_window.flow"))
    inside = sum(recs[n][0].ns for n in WINDOW_SPANS[1:])
    assert inside < window.ns
    assert window.start_ns < flow.start_ns < chain.start_ns
    # the syncs: the chain and the heads' 1/8 warp make their constants on
    # the device and copy nothing from the host; on the CPU the plain LM
    # loop reads its early exit once an iteration run and once where it
    # stops early (the card's solve is one launch)
    syncs = {n: r[0].syncs for n, r in recs.items()}
    n = int(est.last_solver_iters.max())
    assert syncs == {"track_window": n + (n < 20),
                     "track_window.chain": 0, "infer_window.encode": 0,
                     "infer_window.flow": 0, "infer_window.weights": 0,
                     "infer_window.solve": n + (n < 20)}


def test_train_step_records_its_syncs_by_stage():
    trainer, state, data = _trainer("cpu")
    profiling.reset()
    trainer.train_step(state, data)
    names = ("train_step", "train_step.forward", "train_step.backward",
             "train_step.update")
    (step,), (fwd,), (bwd,), (upd,) = (span_records(n) for n in names)
    assert fwd.ns + bwd.ns + upd.ns < step.ns
    assert upd.syncs == 1 and bwd.syncs == 0       # the clip test
    # the forward's: the CPU's plain LM loop reads its early exit once an
    # iteration run and once where it stopped early; nothing else
    n = int(trainer.last_solver_iters.max())
    assert fwd.syncs == n + (n < 20)
    assert step.syncs == fwd.syncs + 1


def test_stage_timer_stages_are_cli_spans():
    with span("cli.track"):                  # before the timer: not its own
        pass
    timer = StageTimer()
    for _ in range(3):
        with timer.stage("track"):
            time.sleep(0.001)
    with timer.stage("readback", sync=torch.ones(2)):
        pass
    recs = span_records("cli.track")
    assert len(recs) == 4 and span_records("cli.readback")
    assert dict(timer.counts) == {"track": 3, "readback": 1}
    assert timer.totals["track"] == pytest.approx(sum(r.ns for r in recs[1:]) / 1e9)
    assert list(timer.summary()) == ["track", "readback"]
    assert timer.summary()["track"] >= 1.0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("track"):
            pass
    assert any(e.name == "cli.track" for e in prof.events())
    assert timer.counts["track"] == 4


def test_costs_file_backward_work_under_the_backward_span():
    """The autograd thread runs the backward: its FLOPs still land under
    ``train_step.backward``, the span the main thread has open."""
    trainer, state, data = _trainer("cpu")
    with costs.count() as counter:
        trainer.train_step(state, data)
    fwd = counter.by_span["train_step.forward"][0]
    bwd = counter.by_span["train_step.backward"][0]
    assert fwd > 0 and bwd > fwd
    assert counter.by_span.get("train_step", [0, 0])[0] == 0


# --- on the card ---------------------------------------------------------------

def _unseen_syncs(fn):
    """(syncs ``torch.cuda.set_sync_debug_mode`` saw in fn(), syncs the
    program counted): each with the file:line where it happened."""
    seen = []
    before = profiling.host_syncs
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for w in caught:
        if "synchroniz" in str(w.message):
            seen.append(f"{w.filename}:{w.lineno}")
    return seen, profiling.host_syncs - before


@pytest.mark.card
def test_the_counter_sees_every_sync_and_records_map_onto_the_trace(
        monkeypatch, card):
    est, windows, masks = _estimator(monkeypatch, card)
    est.track_window(windows[1][0], windows[1][1], masks)
    window = _unseen_syncs(
        lambda: est.track_window(windows[2][0], windows[2][1], masks))
    trainer, state, data = _trainer(card)
    trainer.train_step(state, data)
    step = _unseen_syncs(lambda: trainer.train_step(state, data))
    print("syncs seen, counted: window", window, "step", step)
    assert len(window[0]) == window[1] == 0, window
    assert len(step[0]) == step[1] == 1, step          # the clip test
    # the records of a traced window on the trace's timeline
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for w in (windows[1], windows[2], windows[1]):
            est.track_window(w[0], w[1], masks)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.name == "infer_window.flow"
                     and e.device_type.name == "CPU"),
                    key=lambda e: e.time_range.start)
    recs = span_records("infer_window.flow")
    assert len(events) == len(recs) == 3 and all(r.traced for r in recs)
    for (s, e), ev in zip(profiling.on_trace(recs, prof), events):
        assert abs(s - ev.time_range.start) < 50 and abs(e - ev.time_range.end) < 50


@pytest.mark.card
def test_the_host_keeps_its_lead_through_a_window(monkeypatch, card):
    """A window waits for nothing on the card: under
    ``set_sync_debug_mode("error")`` a whole window raises nothing, and
    queued behind a ~300 ms sleep kernel a window returns while the sleep
    still runs. CUDA's launch queue holds about 1,024 launches, and a full
    queue blocks the host without any sync: a 64x96 window of two frames
    at two GRU iterations makes about 1,080 launches, of one frame at one
    iteration fewer than 1,000, which fit whole."""
    est, windows, masks = _estimator(monkeypatch, card)
    est.track_window(windows[1][0], windows[1][1], masks)
    torch.cuda.set_sync_debug_mode("error")
    try:
        est.track_window(windows[2][0], windows[2][1], masks)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    est, windows, masks = _estimator(monkeypatch, card, iters=1, t=1)
    for w in (windows[1], windows[2]):
        est.track_window(w[0], w[1], masks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(600_000_000)           # ~300 ms at the card's 1.98 GHz
    est.track_window(windows[1][0], windows[1][1], masks)
    dispatched = time.perf_counter() - t0
    torch.cuda.synchronize()
    done = time.perf_counter() - t0
    print(f"window dispatched in {dispatched * 1e3:.1f} ms, done in {done * 1e3:.1f} ms")
    assert done > 0.1 and dispatched < 0.5 * done
