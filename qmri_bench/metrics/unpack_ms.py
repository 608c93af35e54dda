"""unpack_ms: the host seconds of the program's ``dosma.segment.unpack`` span
(the host's unpacking of the masks' bits) a request, in a profiler session
over the cell's traced requests (program_trace.py), in ms."""

from qmri_bench.program_trace import program_trace


def read(ctx):
    prog = program_trace(ctx)
    row = None if prog is None else prog["spans"].get("dosma.segment.unpack")
    return None if row is None else row["host_s"] / prog["requests"] * 1e3
