"""Typed errors for structure and linear-algebra failures.

The same taxonomy as the JAX package's ``sprs_tpu/errors.py``, kept as
its own copy so that the port imports nothing of that package.
"""

from __future__ import annotations


class SprsError(Exception):
    """Base class for all sprs_tpu_torch errors."""


class StructureError(SprsError):
    """A sparse structure invariant is violated.

    Variants carried as the ``kind`` attribute: ``unsorted``,
    ``size_mismatch``, ``out_of_range``, ``index_overflow``.
    """

    def __init__(self, kind: str, msg: str):
        self.kind = kind
        super().__init__(f"{kind}: {msg}")

    @classmethod
    def unsorted(cls, msg: str) -> "StructureError":
        return cls("unsorted", msg)

    @classmethod
    def size_mismatch(cls, msg: str) -> "StructureError":
        return cls("size_mismatch", msg)

    @classmethod
    def out_of_range(cls, msg: str) -> "StructureError":
        return cls("out_of_range", msg)

    @classmethod
    def index_overflow(cls, msg: str) -> "StructureError":
        """The i32 index type cannot address the requested dims/nnz."""
        return cls("index_overflow", msg)


class ShapeError(SprsError):
    """Operand shapes are incompatible for the requested operation."""


class LinalgError(SprsError):
    """Base class for linear-algebra failures."""


class NonSquareMatrixError(LinalgError):
    """A square matrix was required."""


class SingularMatrixError(LinalgError):
    """The matrix is singular (zero pivot / zero diagonal entry)."""


class CapacityError(SprsError):
    """An operation produced more nonzeros than the provided capacity."""

    def __init__(self, required: int, cap: int, message: str = None):
        self.required = required
        self.cap = cap
        super().__init__(
            message
            or f"operation requires capacity {required} but only {cap} "
            "provided"
        )

    @classmethod
    def index_limit(cls, what: str, value: int, hint: str = None) -> "CapacityError":
        """A size crossed the i32 index ceiling, where i32 positions would
        wrap; ``hint`` names the way around it."""
        from .formats.util import MAX_INDEX

        return cls(
            int(value),
            MAX_INDEX,
            f"{what}={int(value)} exceeds the i32 index limit "
            f"{MAX_INDEX}; i32 positions would wrap silently"
            + (f". {hint}" if hint else ""),
        )
