"""Host ms a call of the program's span ``train_step.backward`` (the
main thread's ``backward()`` call, the autograd thread's work inside it),
on the program's own clock: the median over the run's untraced calls;
beside ``backward_ms.train``, the same span's device ms."""
from port_bench import spans


def read(run):
    return spans.host_ms(run, "train_step.backward")
