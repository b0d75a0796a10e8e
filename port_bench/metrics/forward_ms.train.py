"""Device ms a step in the program's span ``train_step.forward``: the
kernels that start in its device windows of the traced slice, over its
steps."""


def read(run):
    tr = run["trace"]
    s = None if tr is None else tr.span_kernel_s("train_step.forward")
    return None if not s else 1e3 * s / tr.units
