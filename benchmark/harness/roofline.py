"""A product's share of its roofline: the least time the card could
take to move the bytes the work needs (each input byte read once, each
output byte written once, at the card's published HBM rate), over the
device time of the ops launched inside the benchmark's ``spmv`` spans,
per call.  The bytes count the work and not the format, so that a
change of kernel or format is read against the same yardstick."""

from __future__ import annotations

from typing import Optional

from .peaks import peak

SPAN = "spmv"


def stencil_bytes(n: int, nnz: int, value_bytes: int) -> int:
    """A stencil needs no structure: its values once, x once, y once."""
    return nnz * value_bytes + 2 * n * value_bytes


def csr_bytes(n: int, nnz: int, value_bytes: int) -> int:
    """Values and 4-byte column indices once, the n + 1 row pointers
    (4 bytes), x once, y once."""
    return nnz * (value_bytes + 4) + (n + 1) * 4 + 2 * n * value_bytes


def share_percent(ctx, nbytes: int) -> Optional[float]:
    """100 · (bytes / peak rate) / (device seconds per spmv call), or
    None where the trace holds no spmv call or the card is not in the
    table of peaks."""
    rate = peak(ctx.device_kind, "hbm_bytes_per_s")
    if ctx.trace is None or rate is None:
        return None
    calls, device_us, ops = ctx.trace.span_device(SPAN)
    if calls == 0 or ops == 0 or device_us <= 0:
        return None
    return 100.0 * (nbytes / rate) / (device_us * 1e-6 / calls)
