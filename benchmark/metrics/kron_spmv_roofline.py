"""The SpMV's share of its bytes roofline in the kron PageRank cell, in
%: bytes = nnz · (value bytes + a 4-byte column index) + the n + 1 row
pointers + x once + y once.  The 2^23 float32 vectors (33.6 MB) fit
the card's 50 MB L2; the stored entries do not."""

from harness.roofline import csr_bytes, share_percent


def read(ctx):
    op = ctx.operator
    return share_percent(ctx, csr_bytes(op["n"], op["nnz"], op["value_bytes"]))
