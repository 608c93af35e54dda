"""train_idle_ms: the card's idle time a request while a ``dosma.train*`` span
of the program (SegTrainer.step and its stages) is the innermost one open,
in a profiler session over the cell's traced requests (program_trace.py),
in ms."""

from qmri_bench.program_trace import per_request


def read(ctx):
    s = per_request(ctx, "idle_s", "dosma.train")
    return None if s is None else s * 1e3
