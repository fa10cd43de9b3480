"""The SpMV's share of its bytes roofline in the heat-example cell, in
%: bytes = nnz · value bytes + x once + y once (a stencil needs no
structure bytes).  At 4096² the float64 vectors (134 MB) exceed the
card's 50 MB L2, and x and y are 28.6 % of the bytes (6.9 % in the
27-point HPCG cell)."""

from harness.roofline import share_percent, stencil_bytes


def read(ctx):
    op = ctx.operator
    return share_percent(ctx, stencil_bytes(op["n"], op["nnz"], op["value_bytes"]))
