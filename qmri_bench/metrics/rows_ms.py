"""rows_ms: the median over the window's requests of the span around
metric_rows, from the CUDA event that closed the fit's span to one after the
rows reached the host."""


def read(ctx):
    return ctx["spans"].median("rows")
