"""IO: Matrix Market text format, validated binary persistence and
checkpoints."""

from .matrix_market import (
    MatrixMarketError,
    MmHeader,
    dumps,
    loads,
    read_matrix_market,
    read_matrix_market_csr,
    write_matrix_market,
    write_matrix_market_sym,
)
from .checkpoint import load_checkpoint, save_checkpoint
from .serialize import load_npz, save_npz

__all__ = [
    "MatrixMarketError",
    "MmHeader",
    "dumps",
    "loads",
    "read_matrix_market",
    "read_matrix_market_csr",
    "write_matrix_market",
    "write_matrix_market_sym",
    "load_checkpoint",
    "save_checkpoint",
    "load_npz",
    "save_npz",
]
