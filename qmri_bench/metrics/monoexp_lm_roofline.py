"""monoexp_lm_roofline: the least time of one fit's work (counts.py: bytes
over the bandwidth or float32 operations over the float32 rate, whichever
is larger) over the mean device time of a monoexp_lm kernel in the trace,
in percent."""

from qmri_bench.counts import least_seconds


def read(ctx):
    trace, work = ctx["trace"], ctx["workload"].work
    if trace is None or work is None:
        return None
    times = [t for name, ts in trace["kernels"].items() if "monoexp_lm" in name for t in ts]
    if not times:
        return None
    return 100.0 * least_seconds(*work) / (sum(times) / len(times))
