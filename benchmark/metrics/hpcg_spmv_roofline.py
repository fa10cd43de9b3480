"""The SpMV's share of its bytes roofline in the HPCG cell, in %:
bytes = nnz · value bytes + x once + y once (a stencil needs no
structure bytes).  At 256³ the vectors (134 MB in float64) and the
stored values (3.6 GB) both exceed the card's 50 MB L2."""

from harness.roofline import share_percent, stencil_bytes


def read(ctx):
    op = ctx.operator
    return share_percent(ctx, stencil_bytes(op["n"], op["nnz"], op["value_bytes"]))
