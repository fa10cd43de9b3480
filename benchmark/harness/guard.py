"""The run's check that nothing of JAX or of the JAX package was loaded:
top-level module names compared whole, so ``sprs_tpu_torch`` (the port)
passes and ``sprs_tpu`` (the JAX package) does not."""

from __future__ import annotations

import sys
from typing import List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "sprs_tpu"})


def forbidden_modules(modules=None) -> List[str]:
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
