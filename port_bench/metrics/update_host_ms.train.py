"""Host ms a call of the program's span ``train_step.update`` (the
metrics, the global norm, the clip test and AdamW's per-leaf update), on
the program's own clock: the median over the run's untraced calls."""
from port_bench import spans


def read(run):
    return spans.host_ms(run, "train_step.update")
