"""Host ms a call of the program's span ``track_window`` (the whole of
``PoseEstimator.track_window``, input conversion included), on the
program's own clock: the median over the run's untraced calls. The inside
counterpart of ``dispatch_ms.f2f``."""
from port_bench import spans


def read(run):
    return spans.host_ms(run, "track_window")
