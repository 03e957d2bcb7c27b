"""Shared model plumbing: transform helpers and input validation — the
counterpart of ``petal_decomposition_tpu/models/_common.py`` (ports of
pca.rs:720-811 plus the dimension checks at pca.rs:199-204, 736-741,
798-803).  The JAX package's complex→host redirect has no counterpart
here: complex tensors stay on the model's device.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..errors import InvalidInput
from ..ops.linalg import mdot

__all__ = [
    "default_device",
    "as_matrix",
    "check_device",
    "model_device",
    "as_input",
    "check_rows",
    "n_rows",
    "fit_record",
    "record",
    "mesh_shards",
    "project_rows",
    "transform_input",
    "check_mesh_complex",
    "gathered",
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


def check_device(device) -> None:
    """Raise when ``device`` is a card and this machine has none, rather
    than run on the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to fit on "
            "the CPU"
        )


def as_matrix(x, device, complex_ok: bool = False) -> torch.Tensor:
    """Coerce input (numpy, tensor, nested lists) to a contiguous 2-D
    floating tensor on ``device``; integers and booleans become float64,
    as in the JAX package.  Complex input raises unless ``complex_ok``
    (the models whose fits take it).  A CUDA ``device`` on a machine
    without a card raises rather than running on the CPU."""
    check_device(device)
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


def model_device(mesh, device) -> torch.device:
    """The device a model's state lives on: a mesh's first device (a
    ``device=`` naming another raises), else ``device``, else the card."""
    from ..parallel.mesh import Mesh

    if isinstance(mesh, Mesh):
        if device is not None and torch.device(device) != mesh.lead:
            raise ValueError(
                f"device={device!r} is not the mesh's first device "
                f"{mesh.lead}; a mesh model lives there"
            )
        return mesh.lead
    return default_device() if device is None else torch.device(device)


def as_input(x, device, mesh, complex_ok: bool = False):
    """A fit's input: :func:`as_matrix` on the model's ``device``, or for
    a mesh fit where it already is (host data stays on the host and each
    shard copies only its own rows).  Row shards already placed on the
    model's mesh (``parallel.rows_from_local``) are taken as they are."""
    from ..parallel.mesh import Rows

    if isinstance(x, Rows):
        check_rows(x, mesh)
        if x.is_complex() and not complex_ok:
            raise NotImplementedError(
                "complex input is not supported by the PyTorch port yet"
            )
        return x
    if mesh is None:
        return as_matrix(x, device, complex_ok)
    for dev in mesh.devices:
        check_device(dev)
    home = x.device if isinstance(x, torch.Tensor) else torch.device("cpu")
    return as_matrix(x, home, complex_ok)


def check_rows(x, mesh) -> None:
    """Row shards are fitted or projected only by a model on their own
    mesh."""
    if x.mesh is None or x.mesh != mesh:
        raise ValueError(
            f"the rows are placed on {x.mesh!r}, not on the model's mesh "
            f"{mesh!r}"
        )


def n_rows(x) -> int:
    """The data rows of a fit's input: a matrix's rows, or the valid rows
    of row shards (their padding left out)."""
    from ..parallel.mesh import Rows

    return x.n_valid if isinstance(x, Rows) else x.shape[0]


@contextlib.contextmanager
def record(model, n: int, d: int, device, mesh=None):
    """:func:`..utils.profiling.record_fit`; the fit's ``extra`` gains
    ``gram_kernel_calls``, the Grams K5 computed in it
    (:mod:`..ops.kernels.gram_syrk`), ``gram_matmul_calls``, those the
    matmul computed in it (:func:`..ops.gram.gram`, every other Gram),
    ``ica_sums_kernel_calls``, the FastICA step sums K6 computed in it
    (:mod:`..ops.kernels.ica_sums`), and a mesh fit's its share of the
    process's collectives, ``collective_calls`` and
    ``collective_bytes``."""
    from ..ops import gram
    from ..ops.kernels import gram_syrk, ica_sums
    from ..parallel.distributed import collectives
    from ..utils.profiling import record_fit

    with record_fit(model, n, d, device) as stats:
        grams, matmuls = gram_syrk.calls, gram.matmul_calls
        sums = ica_sums.calls
        calls, nbytes = collectives.calls, collectives.bytes
        try:
            yield stats
        finally:
            stats.extra["gram_kernel_calls"] = gram_syrk.calls - grams
            stats.extra["gram_matmul_calls"] = gram.matmul_calls - matmuls
            stats.extra["ica_sums_kernel_calls"] = ica_sums.calls - sums
            if mesh is not None:
                stats.extra["collective_calls"] = collectives.calls - calls
                stats.extra["collective_bytes"] = collectives.bytes - nbytes


def fit_record(model, x, mesh):
    """:func:`record` over the input's data rows."""
    return record(model, n_rows(x), x.shape[1], model.device, mesh)


def mesh_shards(x, mesh):
    """A mesh fit's row shards and data rows: ``x`` as it is where it is
    placed already, else the whole matrix zero-padded and sharded."""
    from ..parallel.mesh import Rows, shard_rows_padded

    if isinstance(x, Rows):
        return x, x.n_valid
    return shard_rows_padded(x, mesh)


def project_rows(x, mesh, fn, *state):
    """``fn(shard, *state_on_its_device)`` on every row shard of ``x``,
    each on its own device, gathered as the ``n × k`` result of its data
    rows on every process."""
    check_rows(x, mesh)
    return gathered(x.map(lambda s, _v, *st: fn(s, *st), *state), x.n_valid)


def transform_input(x, device, mesh, components, means, centering: bool):
    """:func:`transform` of a matrix on ``device``, or of row shards,
    each on its own device, gathered."""
    from ..parallel.mesh import Rows

    if isinstance(x, Rows):
        check_fitted(components)
        return project_rows(
            x, mesh, lambda s, w, mu: transform(s, w, mu, centering),
            components, means)
    return transform(as_matrix(x, device, complex_ok=True), components,
                     means, centering)


def check_mesh_complex(mesh, dtype) -> None:
    """The complex-on-mesh contract: complex fits need no mesh or an
    all-CPU one; an accelerator mesh raises ``InvalidInput`` before any
    work."""
    if mesh is None or not dtype.is_complex:
        return
    types = {d.type for d in mesh.devices}
    if types - {"cpu"}:
        raise InvalidInput(
            "complex fits on an accelerator mesh are unsupported, as in "
            "the JAX package: drop .mesh(...) to fit on the model's "
            "device, or build the mesh from CPU devices. "
            f"Mesh devices: {sorted(types)}."
        )


def gathered(u, n: int):
    """A fit's per-row result as one tensor of its ``n`` data rows: row
    shards are gathered (from every process) and their padding cut."""
    from ..parallel.mesh import Rows

    return u.full()[:n] if isinstance(u, Rows) else u


def check_min_dims(x, n_components: int) -> None:
    """Every dimension must be at least n_components (ref: pca.rs:199-204);
    row shards count their data rows."""
    if any(dim < n_components for dim in (n_rows(x),) + tuple(x.shape[1:])):
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
