"""K2's share of its roofline, %: the least time the feature encoder's
instance norms could take in a step (``flops.instance_norm_bytes``: each
norm's forward once, and its statistics entry once where RAFT's gradients
are live, at 3.35e12 B/s) over the device time of the kernels named
``instance_norm_`` in the traced slice (a recomputed forward counts in the
time, not in the bound)."""


def read(run):
    tr, fl = run["trace"], run["flops"]
    t = None if tr is None else tr.kernel_s("instance_norm_")
    if not t:
        return None
    H, W = run["cfg"]["image_shape"]
    w = run["work"]
    need = tr.units * fl.instance_norm_bytes(
        w["fnet"], H, W, backward=w["backward"]) / fl.PEAK_BYTES
    return 100.0 * need / t
