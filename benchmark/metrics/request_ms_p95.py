"""The 95th percentile of every completed request's latency in the
window, in ms (host clock; ``statistics.quantiles``, exclusive)."""

import statistics


def read(ctx):
    if len(ctx.latencies_s) < 20:
        return None
    return statistics.quantiles(ctx.latencies_s, n=20)[18] * 1e3
