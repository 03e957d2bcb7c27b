"""State carried across from the JAX package.

A model fitted by ``petal_decomposition_tpu`` is described by a dict of
numpy arrays and scalars (``np.asarray`` of its attributes — no JAX
object crosses over); :func:`pca_from_numpy`,
:func:`randomized_pca_from_numpy` and :func:`fast_ica_from_numpy`
install that state in a fitted port model, which then transforms and
inverse-transforms as the JAX model does.  The JAX model's PRNG key is
not carried: the port's generator comes from ``state["seed"]`` if
given, else from a random seed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.fast_ica import FastIca
from ..models.pca import Pca
from ..models.randomized_pca import RandomizedPca

__all__ = ["pca_from_numpy", "randomized_pca_from_numpy", "fast_ica_from_numpy"]


def pca_from_numpy(state: dict, device) -> Pca:
    """A fitted :class:`Pca` on ``device`` from JAX-model state.

    ``state`` keys: ``components_``, ``mean_``, ``singular_values_``,
    ``_singular_full``, ``_total_variance``, ``_n_samples``,
    ``n_components``, ``centering``.
    """
    model = Pca(
        int(state["n_components"]),
        centering=bool(state["centering"]),
        device=device,
    )
    return _install(model, state)


def randomized_pca_from_numpy(state: dict, device) -> RandomizedPca:
    """A fitted :class:`RandomizedPca` on ``device`` from JAX-model
    state: :func:`pca_from_numpy`'s keys, and optionally ``seed``."""
    model = RandomizedPca(
        int(state["n_components"]),
        seed=state.get("seed"),
        centering=bool(state["centering"]),
        device=device,
    )
    return _install(model, state)


def fast_ica_from_numpy(state: dict, device) -> FastIca:
    """A fitted :class:`FastIca` on ``device`` from JAX-model state:
    ``components_``, ``mean_``, ``n_iter_``, ``fun``, ``whiten`` and
    ``n_components``, and optionally ``seed``.  Its ``transform``,
    ``inverse_transform`` and ``mixing_`` are then the JAX model's."""
    model = FastIca(
        seed=state.get("seed"),
        fun=state["fun"],
        whiten=bool(state["whiten"]),
        n_components=state["n_components"],
        device=device,
    )
    model._components = _tensor(state, "components_", model.device)
    model._means = _tensor(state, "mean_", model.device)
    model._n_iter = int(state["n_iter_"])
    return model


def _tensor(state: dict, name: str, device) -> torch.Tensor:
    return torch.from_numpy(np.array(state[name])).to(device)


def _install(model, state: dict):
    def tensor(name):
        return _tensor(state, name, model.device)

    model._components = tensor("components_")
    model._means = tensor("mean_")
    model._singular = tensor("singular_values_")
    model._singular_full = tensor("_singular_full")
    model._total_variance = tensor("_total_variance")
    model._n_samples = int(state["_n_samples"])
    return model
