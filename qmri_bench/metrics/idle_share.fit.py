"""idle_share.fit: the share of the traced window of fit requests in which the
card runs no kernel, copy or set, in percent."""


def read(ctx):
    trace = ctx["trace"]
    if trace is None or ctx["workload"].voxels is None or not trace["window_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
