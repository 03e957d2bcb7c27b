"""Model persistence — the counterpart of
``petal_decomposition_tpu/utils/serialize.py``, in the same archive.

The reference serializes a model's whole state, RNG state included, so
a deserialized model transforms identically and continues the same
stream (ref: pca.rs:36-40, 309-315, 936-947; ica.rs:33-39, 422-432).
Every model goes to one ``.npz``: its tensors as numpy arrays
(``.cpu().numpy()``), its scalars and knobs in a JSON header under
``__meta__`` with ``__class__`` and ``__format__`` (version 1; a newer
version is refused).  ``last_fit_stats_``, ``_stream`` (a ``partial_fit``
accumulator) and ``_mixing_cache`` are not state and are skipped; a
model's ``_mesh`` (process-local devices and process group) is written
as null, as the JAX package writes it, so a loaded model has none and
takes a mesh again through its builder's ``.mesh(...)``.  The
model's device is written as a string and never trusted on load:
:func:`load` / :func:`from_bytes` place the tensors on their ``device``
argument, which resolves as a model built without ``device=`` does (the
card).  The port's generator rides along as its state bytes,
``<name>__torchstate`` (``torch.Generator.get_state``).

Cross-loading between the two packages:

* A JAX package archive loads here.  Its arrays and knobs (``_components``,
  ``_means``, ``_singular``, ``_singular_full``, ``_total_variance``,
  ``_n_samples``, ``_n_iter``, the constructor's knobs) become the port's,
  so the model transforms identically.  Its PRNG key
  (``_key__keydata``, threefry's 32-bit words) seeds the port's
  generator deterministically: the words, first word highest, are one
  integer for :func:`..utils.rng.generator_from_seed`.  The draws then
  differ from the JAX model's, whose threefry stream torch cannot
  reproduce.  A JAX archive's ``_mesh`` is null, as a port archive's is.
* A port archive loads into the JAX package unchanged: it holds only
  JSON types and arrays, under the attribute names the two packages
  share, so it transforms identically there.  Its ``_key`` is
  backfilled from ``seed=0`` by the JAX package's own ``from_bytes``.
* Fields an archive lacks (written before they existed) take a default
  instance's values, as in the JAX package.
"""

from __future__ import annotations

import io
import json

import numpy as np
import torch

__all__ = ["save", "load", "to_bytes", "from_bytes"]

# Bump on any incompatible layout change; readers reject newer formats
# with a clear error instead of constructing a silently-wrong model.
_FORMAT_VERSION = 1

_SKIPPED = ("last_fit_stats_", "_stream", "_mixing_cache")
_TORCH_STATE = "__torchstate"
_KEY_DATA = "__keydata"


def _model_state(model) -> tuple[dict, dict]:
    """Split a model's ``__dict__`` into (JSON-able scalars, arrays)."""
    meta = {
        "__class__": type(model).__name__,
        "__format__": _FORMAT_VERSION,
    }
    arrays = {}
    for name, value in vars(model).items():
        if name in _SKIPPED:
            continue
        if name == "_mesh":
            meta[name] = None
        elif value is None or isinstance(value, (bool, int, float, str)):
            meta[name] = value
        elif isinstance(value, torch.device):
            meta[name] = str(value)
        elif isinstance(value, torch.Generator):
            arrays[name + _TORCH_STATE] = value.get_state().numpy()
        elif isinstance(value, torch.Tensor):
            arrays[name] = value.detach().cpu().numpy()
        else:
            raise TypeError(
                f"cannot serialize {name} of type {type(value).__name__}"
            )
    return meta, arrays


def to_bytes(model) -> bytes:
    """In-memory form of :func:`save`.

    >>> from petal_decomposition_tpu_torch import RandomizedPca
    >>> m = from_bytes(to_bytes(RandomizedPca(3, seed=7)), device="cpu")
    >>> type(m).__name__, m.n_components(), str(m.device)
    ('RandomizedPca', 3, 'cpu')
    """
    meta, arrays = _model_state(model)
    buf = io.BytesIO()
    np.savez(
        buf,
        __meta__=np.frombuffer(
            json.dumps(meta).encode("utf-8"), dtype=np.uint8
        ),
        **arrays,
    )
    return buf.getvalue()


def _default_instance(cls, device):
    """A default-constructed model on ``device``, the attribute baseline
    (``seed=0``: no entropy drawn; an archive's own generator state or
    key overwrites it)."""
    if cls.__name__ == "FastIca":
        return cls(seed=0, device=device)
    if cls.__name__ == "RandomizedPca":
        return cls(0, seed=0, device=device)
    return cls(0, device=device)


def _generator_from_key(words: np.ndarray) -> torch.Generator:
    """The port's generator for a JAX key's data (its words, first word
    highest, as one integer seed)."""
    from .rng import generator_from_seed

    seed = 0
    for word in np.asarray(words, np.uint64).ravel():
        seed = (seed << 32) | int(word)
    return generator_from_seed(seed)


def from_bytes(data: bytes, device=None):
    """Load a model from :func:`to_bytes` output (or a JAX package
    archive), its tensors on ``device`` (default: the card)."""
    from ..models import _common
    from ..models.fast_ica import FastIca
    from ..models.pca import Pca
    from ..models.randomized_pca import RandomizedPca

    device = (_common.default_device() if device is None
              else torch.device(device))
    _common.check_device(device)
    classes = {c.__name__: c for c in (Pca, RandomizedPca, FastIca)}
    with np.load(io.BytesIO(data)) as npz:
        meta = json.loads(bytes(npz["__meta__"].tobytes()).decode("utf-8"))
        arrays = {n: npz[n] for n in npz.files if n != "__meta__"}
    fmt = meta.pop("__format__", 1)
    if fmt > _FORMAT_VERSION:
        raise ValueError(
            f"serialized model uses format v{fmt}; this version of "
            f"petal_decomposition_tpu_torch reads up to v{_FORMAT_VERSION} "
            "— upgrade the library to load it"
        )
    cls = classes[meta.pop("__class__")]
    model = cls.__new__(cls)
    fields = vars(_default_instance(cls, device))
    for name, value in fields.items():
        setattr(model, name, value)
    for name, value in meta.items():
        if name in fields and name != "_device":
            setattr(model, name, value)
    for name, arr in arrays.items():
        base = name[: -len(_TORCH_STATE)]
        if name.endswith(_TORCH_STATE) and base in fields:
            gen = torch.Generator()
            gen.set_state(torch.from_numpy(arr.copy()))
            setattr(model, base, gen)
        elif name.endswith(_KEY_DATA):
            # The JAX package's ``_key``; the port's own state wins.
            if "_gen" + _TORCH_STATE not in arrays:
                model._gen = _generator_from_key(arr)
        elif name in fields:
            setattr(model, name, torch.from_numpy(arr.copy()).to(device))
    return model


def save(model, path) -> None:
    """Serialize a fitted (or unfitted) model to ``path`` (.npz).

    A loaded model transforms identically and continues the same random
    stream (the reference's serde contract, pca.rs:309-315).

    >>> import numpy as np, tempfile, os
    >>> from petal_decomposition_tpu_torch import Pca, save, load
    >>> x = np.random.default_rng(0).standard_normal((50, 4))
    >>> m = Pca(2, device="cpu").fit(x)
    >>> with tempfile.TemporaryDirectory() as d:
    ...     p = os.path.join(d, "model.npz")
    ...     save(m, p)
    ...     m2 = load(p, device="cpu")
    >>> bool((m2.transform(x) == m.transform(x)).all())
    True
    """
    with open(path, "wb") as f:
        f.write(to_bytes(model))


def load(path, device=None):
    """Load a model written by :func:`save` (or by the JAX package's
    ``save``) with its tensors on ``device`` (default: the card; see the
    module docstring for the round-trip and cross-loading contract)."""
    with open(path, "rb") as f:
        return from_bytes(f.read(), device=device)
