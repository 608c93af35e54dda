"""launches_per_iter: kernel and graph launch calls made by the host in the
traced registrations, over their Adam iterations."""


def read(ctx):
    trace, iters = ctx["trace"], ctx["workload"].iterations
    if trace is None or not iters or not trace["launches"]:
        return None
    return trace["launches"] / trace["requests"] / iters
