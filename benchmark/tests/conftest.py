"""The benchmark's tests import its modules the way ``run.py`` does:
the checkout's root and ``benchmark/`` on the path."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
