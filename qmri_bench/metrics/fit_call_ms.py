"""fit_call_ms: the median over the window's requests of the span around the
call into the fit facade (MonoExponentialFit.fit, or the scan's map
method), from a CUDA event before it to one after it."""


def read(ctx):
    return ctx["spans"].median("fit_call")
