"""Device idle µs inside the benchmark's ``cg`` spans per CG iteration
run in them: the solver loop's host issue and its per-iteration sync."""


def read(ctx):
    t = ctx.trace
    iters = ctx.counters.get("cg_iterations", 0)
    if t is None or not t.device or not iters:
        return None
    spans, idle_us = t.span_idle_us("cg")
    return idle_us / iters if spans else None
