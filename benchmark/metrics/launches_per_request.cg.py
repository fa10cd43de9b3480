"""Device ops (kernels, copies, sets) started in the traced window per
request completed in it, in the CG-set cells.  A CUDA graph or a fusion shows
here."""

from harness.trace import ops_per_request


def read(ctx):
    return ops_per_request(ctx.trace, ctx.completed)
