"""Nonzero-pattern visualization, the counterpart of
``sprs_tpu/utils/visu.py``: an ASCII pattern printer and a u8 pattern
image, computed on the host from the stored entries."""

from __future__ import annotations

import numpy as np

from ..formats.csmat import CsMat


def nnz_pattern(mat: CsMat) -> np.ndarray:
    """Boolean dense pattern of stored entries."""
    csr = mat.to_csr()
    nnz = csr.nnz
    rows = csr.outer_ids()[:nnz].cpu().numpy()
    cols = csr.indices[:nnz].cpu().numpy()
    out = np.zeros(csr.shape, dtype=bool)
    out[rows, cols] = True
    return out


def nnz_pattern_str(mat: CsMat, *, nnz_char: str = "x", zero_char: str = " ") -> str:
    """ASCII art of the pattern: one ``|...|`` line per row."""
    pat = nnz_pattern(mat)
    lines = ["|" + "".join(nnz_char if v else zero_char for v in row) + "|" for row in pat]
    return "\n".join(lines)


def nnz_image(mat: CsMat) -> np.ndarray:
    """u8 image of the pattern: 0 where stored, 255 elsewhere."""
    pat = nnz_pattern(mat)
    return np.where(pat, np.uint8(0), np.uint8(255))
