"""Device ms per BiCGSTAB iteration of the ops launched inside the
benchmark's ``bicgstab`` spans but not inside its ``spmv`` spans: the
solver's own vector work (the masked ``torch.where`` updates, the
axpys, the dots and norms), without the products."""


def read(ctx):
    t = ctx.trace
    iters = ctx.counters.get("bicgstab_iterations", 0)
    if t is None or not t.device or not iters:
        return None
    spans, solve_us, ops = t.span_device("bicgstab")
    _, spmv_us, _ = t.span_device("spmv")
    if not spans or not ops or solve_us - spmv_us <= 0:
        return None
    return (solve_us - spmv_us) / iters / 1e3
