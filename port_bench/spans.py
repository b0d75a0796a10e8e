"""What the per-layer metrics of ``source: program_span`` and
``program_counter`` read from the program's own recorder
(``robust_pose_tpu_torch.utils.profiling``: each call of a span, its host
ns on the program's clock, the host syncs counted while it was open, and
whether a torch.profiler was tracing it).

A reader takes the span's calls that no profiler traced: those of the
timed window and the few of set-up, which the median absorbs. It returns
None on a run not on the card, and where the program keeps no such
records (a program without the recorder) or the span never ran.
"""
from __future__ import annotations

import statistics


def median(run, name: str, field: str):
    """The median of ``field`` (``ns`` or ``syncs``) over the untraced
    calls of span ``name``, or None."""
    if run["trace"] is None:            # not a run on the card
        return None
    from robust_pose_tpu_torch.utils import profiling

    records = getattr(profiling, "span_records", None)
    if records is None:
        return None
    values = [getattr(r, field) for r in records(name) if not r.traced]
    return statistics.median(values) if values else None


def host_ms(run, name: str):
    """Host ms a call of span ``name``: the median over its untraced calls."""
    ns = median(run, name, "ns")
    return None if ns is None else ns / 1e6
