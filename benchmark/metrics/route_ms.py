"""Mean ms of ``prepare_spmv`` per build in the traced window: a host
span around the call, from a synchronise to a synchronise."""

import statistics


def read(ctx):
    v = ctx.host_ms.get("route")
    return statistics.fmean(v) if v else None
