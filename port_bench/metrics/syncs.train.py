"""Host syncs a call of the program's span ``train_step``: the reads of a
device value through ``profiling.host_read`` and the syncs counted beside
ops that wait on their own, while the step was open; the median over the
run's untraced calls."""
from port_bench import spans


def read(run):
    return spans.median(run, "train_step", "syncs")
