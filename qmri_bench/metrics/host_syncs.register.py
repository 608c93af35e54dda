"""host_syncs.register: the host's waits on the card that start inside a
``dosma.register*`` span of the program, over the Adam iterations that ran
(the program's counter ``adam.iterations``), in the traced registrations of
program_trace.py."""

from qmri_bench.program_trace import per_request, program_trace


def read(ctx):
    syncs = per_request(ctx, "syncs", "dosma.register")
    prog = program_trace(ctx)
    iters = prog["counters"].get("adam.iterations", 0) if prog is not None else 0
    if syncs is None or not iters:
        return None
    return syncs * prog["requests"] / iters
