"""Row-sharded fits over device meshes and process groups."""

from .distributed import fast_ica_fit, pca_fit_gram, randomized_pca_fit
from .mesh import (
    ROWS,
    Mesh,
    Rows,
    make_mesh,
    rows_from_local,
    shard_rows,
    shard_rows_padded,
)

__all__ = [
    "make_mesh",
    "shard_rows",
    "shard_rows_padded",
    "rows_from_local",
    "Mesh",
    "Rows",
    "ROWS",
    "pca_fit_gram",
    "randomized_pca_fit",
    "fast_ica_fit",
]
