"""register_ms_per_iter: the median registration span of the window over the
Adam iterations of the parameter file's schedule (3 resolutions x 250)."""


def read(ctx):
    iters = ctx["workload"].iterations
    span = ctx["spans"].median("register")
    if not iters or span is None:
        return None
    return span / iters
