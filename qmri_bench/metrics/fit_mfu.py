"""fit_mfu: the least time of one fit's work (the count of
monoexp_lm_roofline) over the mean request time in the traced window, in
percent: defined whatever implements the fit."""

from qmri_bench.counts import least_seconds


def read(ctx):
    trace, work = ctx["trace"], ctx["workload"].work
    if trace is None or work is None or not trace["window_s"]:
        return None
    return 100.0 * least_seconds(*work) / (trace["window_s"] / trace["requests"])
