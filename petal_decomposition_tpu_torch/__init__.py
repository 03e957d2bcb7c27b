"""petal-decomposition-tpu, ported to PyTorch and CUDA.

The counterpart of ``petal_decomposition_tpu`` for NVIDIA Hopper: the
same algorithms, API, error taxonomy and tolerances, in plain PyTorch
around kernels written by hand for the card.  It imports ``torch`` and
never ``jax``.  Ported so far: the in-core exact and randomized PCA.

>>> from petal_decomposition_tpu_torch import (
...     Pca, PcaBuilder, RandomizedPca, RandomizedPcaBuilder,
...     DecompositionError,
... )
"""

from .config import config
from .errors import DecompositionError, InvalidInput, LinalgError
from .models.pca import Pca, PcaBuilder
from .models.randomized_pca import RandomizedPca, RandomizedPcaBuilder

__all__ = [
    "Pca",
    "PcaBuilder",
    "RandomizedPca",
    "RandomizedPcaBuilder",
    "DecompositionError",
    "InvalidInput",
    "LinalgError",
    "config",
]

__version__ = "0.5.0"
