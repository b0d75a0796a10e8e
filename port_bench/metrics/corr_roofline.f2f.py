"""K1's share of its roofline, %: the least time its lookups could take
(``flops.corr_window_bytes`` of the window's RAFT pairs, one lookup each
GRU iteration, at 3.35e12 B/s) over the device time of the kernels named
``corr_window`` in the traced slice."""


def read(run):
    tr, fl = run["trace"], run["flops"]
    t = None if tr is None else tr.kernel_s("corr_window")
    if not t:
        return None
    H, W = run["cfg"]["image_shape"]
    calls = run["cfg"]["model"]["iters"] * tr.units
    need = calls * fl.corr_window_bytes(run["work"]["pairs"], H, W) / fl.PEAK_BYTES
    return 100.0 * need / t
