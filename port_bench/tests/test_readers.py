"""The per-layer metrics that read the program's span recorder
(``port_bench/spans.py``): None on a run not on the card, and on a run
with a trace the median over the span's untraced calls, the traced ones
left out."""
import statistics
import time
from pathlib import Path

import pytest
from torch.profiler import ProfilerActivity, profile

from port_bench import cells

ROOT = Path(__file__).resolve().parents[2]
READS = {"window_host_ms.f2f": "track_window",
         "chain_host_ms.f2f": "track_window.chain",
         "flow_host_ms.f2f": "infer_window.flow",
         "backward_host_ms.train": "train_step.backward",
         "update_host_ms.train": "train_step.update"}


@pytest.fixture()
def recorder():
    from robust_pose_tpu_torch.utils import profiling

    profiling.reset()
    yield profiling
    profiling.reset()


def _calls(profiling, name, seconds, syncs):
    with profiling.span(name):
        time.sleep(seconds)
        for _ in range(syncs):
            profiling.count_sync()


def _record(profiling):
    """Three untraced calls of each span (1-3 ms, one sync each), then
    four traced ones (10 ms, five syncs each) that would move a median
    taken over all seven."""
    for name in [*READS.values(), "train_step"]:
        for k in range(3):
            _calls(profiling, name, 1e-3 * (k + 1), 1)
    with profile(activities=[ProfilerActivity.CPU]):
        for name in [*READS.values(), "train_step"]:
            for _ in range(4):
                _calls(profiling, name, 1e-2, 5)


def test_the_entries_name_their_readers():
    bench = cells.benchmark(ROOT)
    new = {m["name"]: m for m in bench["per_layer"]
           if m["name"] in [*READS, "syncs.train"]}
    assert len(new) == 6
    assert new["syncs.train"]["source"] == "program_counter"
    assert all(new[n]["source"] == "program_span" for n in READS)


@pytest.mark.parametrize("name", [*READS, "syncs.train"])
def test_none_on_a_run_not_on_the_card(name, recorder):
    _record(recorder)
    assert cells.metric_reader(name)({"trace": None}) is None


@pytest.mark.parametrize("name", list(READS))
def test_host_ms_is_the_median_of_the_untraced_calls(name, recorder):
    _record(recorder)
    recs = recorder.span_records(READS[name])
    assert [r.traced for r in recs] == [False] * 3 + [True] * 4
    want = statistics.median(r.ns for r in recs if not r.traced) / 1e6
    got = cells.metric_reader(name)({"trace": object()})
    assert got == want and 1.0 <= got < 5.0


def test_syncs_is_the_median_of_the_untraced_steps(recorder):
    _record(recorder)
    assert cells.metric_reader("syncs.train")({"trace": object()}) == 1


def test_none_where_the_span_never_ran(recorder):
    assert cells.metric_reader("window_host_ms.f2f")({"trace": object()}) is None


@pytest.mark.parametrize("name", [*READS, "syncs.train"])
def test_none_from_a_program_without_the_recorder(name, recorder, monkeypatch):
    """A program whose spans keep no records (before the recorder) gives
    no reading, and raises nothing."""
    _record(recorder)
    monkeypatch.delattr(recorder, "span_records")
    assert cells.metric_reader(name)({"trace": object()}) is None
