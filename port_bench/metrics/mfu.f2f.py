"""The whole window's share of the card's bf16 peak, %: the analytic FLOPs
of a window (``flops.work_flops``, from the configuration's shapes) times
the measured windows a second (track_fps over T), over 989e12."""


def read(run):
    if run["trace"] is None:        # not a run on the card
        return None
    fl = run["flops"]
    w = run["work"]
    return 100.0 * fl.work_flops(run["cfg"], w) * run["rate"] / w["per_rate"] / fl.PEAK_FLOPS
