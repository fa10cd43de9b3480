"""Device idle µs inside the program's ``sprs.bicgstab.sync`` spans per
BiCGSTAB iteration: the part of the solver loop's gap in which the host
waits on a device value (the loop's convergence test, then
``converged`` and the final residual norm) and wakes up."""


def read(ctx):
    t = ctx.trace
    iters = ctx.counters.get("bicgstab_iterations", 0)
    if t is None or not t.device or not iters:
        return None
    spans, idle_us = t.span_idle_us("sprs.bicgstab.sync")
    return idle_us / iters if spans else None
