"""Host ms a call of the program's span ``track_window.chain``
(``_rel_check``, the chain of the window's T poses and the carried
frame), on the program's own clock: the median over the run's untraced
calls."""
from port_bench import spans


def read(run):
    return spans.host_ms(run, "track_window.chain")
