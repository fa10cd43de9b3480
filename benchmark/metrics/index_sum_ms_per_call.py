"""Device ms of the ops launched inside the program's ``sprs.index_sum``
spans, per call: ``index_sum_``'s accumulating ``index_put_`` on the
card, its sort of the slots and its sums."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.device:
        return None
    calls, device_us, ops = t.span_device("sprs.index_sum")
    return device_us / calls / 1e3 if calls and ops and device_us > 0 else None
