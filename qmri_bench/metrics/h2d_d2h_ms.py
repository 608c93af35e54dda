"""h2d_d2h_ms: device time of the host-to-card and card-to-host copies in the
trace, per request."""


def read(ctx):
    trace = ctx["trace"]
    if trace is None:
        return None
    s = trace["copies"].get("HtoD", 0.0) + trace["copies"].get("DtoH", 0.0)
    return s / trace["requests"] * 1e3 if s > 0 else None
