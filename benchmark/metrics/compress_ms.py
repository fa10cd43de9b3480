"""Mean ms of ``coo_to_csmat`` per build in the traced window: a host
span around the call, from a synchronise to a synchronise."""

import statistics


def read(ctx):
    v = ctx.host_ms.get("compress")
    return statistics.fmean(v) if v else None
