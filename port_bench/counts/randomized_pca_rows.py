"""A row-sharded ``RandomizedPca`` fit does the whole matrix's work,
spread over the mesh: ``randomized_pca``'s counts, of the whole matrix."""

from .randomized_pca import (  # noqa: F401
    fit_ops,
    gram_pass_bytes,
    gram_pass_ops,
    moments_ops,
    qr_ops,
    solve_ops,
)
