"""petal-decomposition-tpu, ported to PyTorch and CUDA.

The counterpart of ``petal_decomposition_tpu`` for NVIDIA Hopper: the
same algorithms, API, error taxonomy and tolerances, in plain PyTorch
around kernels written by hand for the card.  It imports ``torch`` and
never ``jax``.  Ported: exact PCA, randomized PCA and FastICA, real and
complex, in core and streamed from host blocks (real); row-sharded fits
on a device mesh and across processes (``parallel``: ``make_mesh``,
``multihost.initialize``); ``save``/``load`` in the JAX package's
archive; the ``"native"`` host backend and the tiny-fit host offload;
``utils.debugging`` (``nan_debugging``, ``check_finite``).

>>> from petal_decomposition_tpu_torch import (
...     Pca, PcaBuilder, RandomizedPca, RandomizedPcaBuilder,
...     FastIca, FastIcaBuilder, DecompositionError, save, load,
... )
"""

from .config import config
from .errors import DecompositionError, InvalidInput, LinalgError
from .models.fast_ica import FastIca, FastIcaBuilder
from .models.pca import Pca, PcaBuilder
from .models.randomized_pca import RandomizedPca, RandomizedPcaBuilder
from .utils.serialize import load, save

__all__ = [
    "Pca",
    "PcaBuilder",
    "RandomizedPca",
    "RandomizedPcaBuilder",
    "FastIca",
    "FastIcaBuilder",
    "DecompositionError",
    "InvalidInput",
    "LinalgError",
    "config",
    "save",
    "load",
]

__version__ = "0.5.0"
