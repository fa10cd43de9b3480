"""The device's idle share of the traced window in the graph cells, in %:
100 · (1 - union of the device ops' intervals / the window)."""

from harness.trace import idle_percent


def read(ctx):
    return idle_percent(ctx.trace)
