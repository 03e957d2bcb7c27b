"""The check that nothing a run loads is JAX or the JAX package.

Top-level module names are compared whole: the program's package,
``petal_decomposition_tpu_torch``, begins with the JAX package's name and
is not the JAX package.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "petal_decomposition_tpu")
PROGRAM = "petal_decomposition_tpu_torch"


def top_level(names) -> set[str]:
    return {n.split(".")[0] for n in names}


def forbidden_loaded(modules=None, forbidden=FORBIDDEN) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: this
    process's ``sys.modules``), sorted."""
    names = sys.modules if modules is None else modules
    return sorted(top_level(names) & set(forbidden))
