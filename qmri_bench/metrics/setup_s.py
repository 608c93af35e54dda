"""setup_s: seconds from the start of the process to the first timed request
(imports, inputs made from the seed, the kernels' builds or loads, warm-up)."""


def read(ctx):
    return ctx["setup_s"]
