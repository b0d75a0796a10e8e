"""Device ms a window in the program's span ``infer_window.flow`` (RAFT's
GRU iterations and upsampling over the window's 2T pairs): the kernels
that start in the span's device windows of the traced slice, over its
windows."""


def read(run):
    tr = run["trace"]
    s = None if tr is None else tr.span_kernel_s("infer_window.flow")
    return None if not s else 1e3 * s / tr.units
