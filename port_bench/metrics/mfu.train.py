"""The whole step's share of the card's bf16 peak, %: the analytic FLOPs
of a step (``flops.work_flops``: forward, and the backward the job
computes, without recomputation) times the measured steps a second
(samples a second over B), over 989e12."""


def read(run):
    if run["trace"] is None:        # not a run on the card
        return None
    fl = run["flops"]
    w = run["work"]
    return 100.0 * fl.work_flops(run["cfg"], w) * run["rate"] / w["per_rate"] / fl.PEAK_FLOPS
