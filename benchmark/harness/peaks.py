"""Published peaks of the cards the benchmark runs on, by the name that
``torch.cuda.get_device_name()`` gives.

NVIDIA H100 SXM (data sheet, at its 700 W power limit): 80 GB of HBM3
at 3.35 TB/s.  A card set below 700 W runs slower under load; the run
records the card's ``power.limit`` beside its numbers.
"""

from __future__ import annotations

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peak(kind: Optional[str], key: str) -> Optional[float]:
    """The card's published ``key``, or None for a card not in the table
    (a reader then reports nothing)."""
    return PEAKS.get(kind or "", {}).get(key)
