"""Device idle µs inside the benchmark's ``bicgstab`` spans per BiCGSTAB
iteration run in them: the solver loop's host issue and its
per-iteration sync."""


def read(ctx):
    t = ctx.trace
    iters = ctx.counters.get("bicgstab_iterations", 0)
    if t is None or not t.device or not iters:
        return None
    spans, idle_us = t.span_idle_us("bicgstab")
    return idle_us / iters if spans else None
