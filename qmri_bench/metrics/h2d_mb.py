"""h2d_mb: the bytes that the program copies from host memory to the card a
request (its counter ``h2d.bytes``, read before and after the traced
requests of program_trace.py), in MB."""

from qmri_bench.program_trace import program_trace


def read(ctx):
    prog = program_trace(ctx)
    if prog is None:
        return None
    return prog["counters"].get("h2d.bytes", 0) / prog["requests"] / 1e6
