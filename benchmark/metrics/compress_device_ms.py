"""Device ms of the ops launched inside the program's
``sprs.coo_to_csmat`` spans, per call: the assembly's sort, duplicate
sum and row pointers on the card, without the host time and the two
synchronisations that ``compress_ms`` includes."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.device:
        return None
    calls, device_us, ops = t.span_device("sprs.coo_to_csmat")
    return device_us / calls / 1e3 if calls and ops and device_us > 0 else None
