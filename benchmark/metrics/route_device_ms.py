"""Device ms of the ops launched inside the program's
``sprs.prepare_spmv`` spans, per call: the routing rule's structure
counts and the chosen conversion on the card, without the host time and
the two synchronisations that ``route_ms`` includes."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.device:
        return None
    calls, device_us, ops = t.span_device("sprs.prepare_spmv")
    return device_us / calls / 1e3 if calls and ops and device_us > 0 else None
