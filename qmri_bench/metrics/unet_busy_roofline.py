"""unet_busy_roofline: the least time of a knee's segmentation (counts_unet.py,
as fit_mfu reads it in this cell) over the card's busy time a traced request (the union of its
kernels, copies and sets), in percent: the forward's kernels' share of
their roofline, the card's idle time left out."""

from qmri_bench.counts import least_seconds


def read(ctx):
    trace, work = ctx["trace"], ctx["workload"].work
    if trace is None or work is None or not trace["busy_s"]:
        return None
    return 100.0 * least_seconds(*work) / (trace["busy_s"] / trace["requests"])
