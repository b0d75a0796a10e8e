"""Host ms to enqueue one window (``track_window`` returning), the median
over the measured window's calls, on the host clock."""
import statistics


def read(run):
    d = run["host"].get("dispatch_s")
    return 1e3 * statistics.median(d) if d else None
