"""Device idle µs inside the program's kernel-launch spans, per span:
``sprs.k1`` (K1's direct launch through its plan) and ``sprs.k5`` (K5
through its autograd ``Function``).  Where the card waits on the host,
it is the host's path from the product's call to its kernel's start."""

SPANS = ("sprs.k1", "sprs.k5")


def read(ctx):
    t = ctx.trace
    if t is None or not t.device:
        return None
    calls = idle_us = 0
    for name in SPANS:
        n, us = t.span_idle_us(name)
        calls += n
        idle_us += us
    return idle_us / calls if calls else None
