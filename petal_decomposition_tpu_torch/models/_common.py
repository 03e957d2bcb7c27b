"""Shared model plumbing: transform helpers and input validation — the
counterpart of ``petal_decomposition_tpu/models/_common.py`` (ports of
pca.rs:720-811 plus the dimension checks at pca.rs:199-204, 736-741,
798-803).  The JAX package's complex→host redirect and mesh helpers
have no counterpart here: complex tensors stay on the model's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import InvalidInput
from ..ops.linalg import mdot

__all__ = [
    "default_device",
    "as_matrix",
    "reject_mesh",
    "streamed_not_ported",
    "check_min_dims",
    "check_fitted",
    "real_dtype",
    "transform",
    "transform_with_u",
    "inverse_transform",
]


def default_device() -> torch.device:
    """The device of a model built without ``device=``: the card.  The
    CPU is taken only when the caller asks for it; with no card, the
    model's fit raises (:func:`as_matrix`)."""
    return torch.device("cuda")


def as_matrix(x, device, complex_ok: bool = False) -> torch.Tensor:
    """Coerce input (numpy, tensor, nested lists) to a contiguous 2-D
    floating tensor on ``device``; integers and booleans become float64,
    as in the JAX package.  Complex input raises unless ``complex_ok``
    (the models whose fits take it).  A CUDA ``device`` on a machine
    without a card raises rather than running on the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to fit on "
            "the CPU"
        )
    if isinstance(x, torch.Tensor):
        t = x
    else:
        a = np.asarray(x)
        # torch.from_numpy needs a writable buffer (read-only arrays such
        # as memmaps or views of JAX arrays are copied once).
        t = torch.from_numpy(a if a.flags.writeable else a.copy())
    if t.dim() != 2:
        raise InvalidInput(f"expected a 2-dimensional matrix, got {t.dim()}-d")
    if t.is_complex() and not complex_ok:
        raise NotImplementedError(
            "complex input is not supported by the PyTorch port yet"
        )
    if not (t.is_floating_point() or t.is_complex()):
        t = t.to(torch.float64)
    return t.to(device).contiguous()


def reject_mesh(mesh) -> None:
    """Device meshes are not ported yet: a model given one raises."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh fits are not ported to PyTorch yet (ROADMAP.md §1 "
            "item 8); fit on one device"
        )


def streamed_not_ported(*_args, **_kwargs):
    """The streamed fits and transforms are not ported yet."""
    raise NotImplementedError(
        "streamed fits and transforms are not ported to PyTorch yet "
        "(ROADMAP.md §1 item 6)"
    )


def check_min_dims(x, n_components: int) -> None:
    """Every dimension must be at least n_components (ref: pca.rs:199-204)."""
    if any(dim < n_components for dim in x.shape):
        raise InvalidInput(
            f"every dimension should be at least {n_components}"
        )


def check_fitted(components) -> None:
    if components is None:
        raise InvalidInput("model has not been fitted")


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """The real dtype matching ``dtype``."""
    return dtype.to_real() if dtype.is_complex else dtype


def transform(x, components, means, centering: bool):
    """Project onto the fitted components: ``(x - μ)·Wᴴ``
    (ref: pca.rs:726-750; the conjugate transpose for complex data, as
    the JAX package deliberately deviates there)."""
    check_fitted(components)
    if x.shape[1] != means.shape[0]:
        raise InvalidInput(f"# of columns should be {means.shape[0]}")
    target = torch.promote_types(x.dtype, components.dtype)
    x = x.to(target)
    if centering:
        x = x - means
    return mdot(x, components.mH.to(target))


def transform_with_u(u, singular, n_components: int):
    """Projected data straight from the SVD: ``U[:, :k]·diag(σ[:k])``
    (ref: pca.rs:758-779)."""
    k = n_components
    return u[:, :k] * singular[:k].to(u.dtype)[None, :]


def inverse_transform(y, components, means, centering: bool):
    """Back-project to the original space: ``y·W + μ``
    (ref: pca.rs:788-811)."""
    check_fitted(components)
    y = as_matrix(y, components.device, complex_ok=True)
    if y.shape[1] != components.shape[0]:
        raise InvalidInput(f"# of columns should be {components.shape[0]}")
    target = torch.promote_types(y.dtype, components.dtype)
    out = mdot(y.to(target), components.to(target))
    if centering:
        out = out + means
    return out
