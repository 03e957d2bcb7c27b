"""Error taxonomy mirroring the reference's ``DecompositionError``.

The reference defines a two-variant error enum (``InvalidInput`` and
``LinalgError``) at ``src/lib.rs:22-28``.  In Python these become an
exception hierarchy: :class:`DecompositionError` is the common base and
the two variants are subclasses, so ``except DecompositionError`` catches
both while ``except InvalidInput`` narrows to shape/layout violations.
"""

from __future__ import annotations

__all__ = ["DecompositionError", "InvalidInput", "LinalgError"]


class DecompositionError(Exception):
    """Base error for decomposition operations (ref: src/lib.rs:22-28)."""


class InvalidInput(DecompositionError):
    """The input matrix has an invalid shape or layout.

    Mirrors ``DecompositionError::InvalidInput`` (src/lib.rs:24-25); raised
    for dimension mismatches (ref: pca.rs:199-204, pca.rs:736-741,
    pca.rs:798-803, ica.rs:124-128).
    """

    def __str__(self) -> str:  # match "invalid matrix: {0}" (lib.rs:24)
        return f"invalid matrix: {super().__str__()}"


class LinalgError(DecompositionError):
    """A linear-algebra routine failed to converge.

    Mirrors ``DecompositionError::LinalgError`` (src/lib.rs:26-27); raised
    when an iterative factorization (Jacobi SVD/eigh) fails to converge
    within its sweep budget — the analogue of LAPACK ``info != 0``
    (ref: linalg.rs:84, linalg.rs:115).
    """

    def __str__(self) -> str:  # match "linear algerba operation failed: {0}"
        return f"linear algebra operation failed: {super().__str__()}"
