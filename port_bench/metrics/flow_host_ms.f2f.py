"""Host ms a call of the program's span ``infer_window.flow`` (enqueueing
RAFT's GRU iterations and upsampling over the window's 2T pairs), on the
program's own clock: the median over the run's untraced calls; beside
``flow_ms.f2f``, the same span's device ms."""
from port_bench import spans


def read(run):
    return spans.host_ms(run, "infer_window.flow")
