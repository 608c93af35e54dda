"""train_place_ms: the host seconds of the program's ``dosma.train.place`` span
(the batch made float32 on the host and its crossing to the card) a
request, in a profiler session over the cell's traced requests
(program_trace.py), in ms."""

from qmri_bench.program_trace import program_trace


def read(ctx):
    prog = program_trace(ctx)
    row = None if prog is None else prog["spans"].get("dosma.train.place")
    return None if row is None else row["host_s"] / prog["requests"] * 1e3
