"""A row-sharded fit is held to the whole matrix's answers: the plain
reference is ``randomized_pca``'s, fed the whole matrix in row order."""

from .randomized_pca import (  # noqa: F401
    Moments,
    Solution,
    eigen_residual,
    moments,
    solve,
    subspace,
    u_pivots,
    v_pivots,
)
