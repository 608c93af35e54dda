"""host_syncs: the host's waits on the card (cudaStreamSynchronize,
cudaDeviceSynchronize, cudaEventSynchronize) a request that start inside a
``dosma.*`` span of the program, in a profiler session over the cell's traced
requests (program_trace.py)."""

from qmri_bench.program_trace import per_request


def read(ctx):
    return per_request(ctx, "syncs")
