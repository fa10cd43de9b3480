"""The SpMV's share of its bytes roofline in the permuted HPCG cell, in
%: bytes = nnz · (value bytes + a 4-byte column index) + the n + 1 row
pointers + x once + y once.  At 256³ the vectors (134 MB) exceed the
card's 50 MB L2."""

from harness.roofline import csr_bytes, share_percent


def read(ctx):
    op = ctx.operator
    return share_percent(ctx, csr_bytes(op["n"], op["nnz"], op["value_bytes"]))
