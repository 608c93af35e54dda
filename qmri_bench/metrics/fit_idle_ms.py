"""fit_idle_ms: the card's idle time a request while a ``dosma.fit*`` span of
the program (the fit facade and its stages, the scan's map method) is the
innermost one open, in a profiler session over the cell's traced requests
(program_trace.py), in ms."""

from qmri_bench.program_trace import per_request


def read(ctx):
    s = per_request(ctx, "idle_s", "dosma.fit")
    return None if s is None else s * 1e3
