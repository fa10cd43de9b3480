"""Seconds from the start of the process to the first timed request:
CUDA initialisation, loading (and on a checkout's first run, building)
the kernels, making the inputs from the seed, the cell's own assembly
and preparation, and the warm-up requests."""


def read(ctx):
    return ctx.setup_s
