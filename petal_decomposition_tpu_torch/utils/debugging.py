"""Numerical-safety tooling — the counterpart of
``petal_decomposition_tpu/utils/debugging.py``.

* :func:`nan_debugging` — raise ``FloatingPointError`` at the first
  operation in the block whose floating or complex output holds a NaN,
  as ``jax.debug_nans`` does.  A ``TorchDispatchMode`` checks every ATen
  operation's outputs, but a view's (it holds no new value) and an
  allocation's.  The hand-written kernels write through ctypes
  into tensors the mode saw allocated, so each kernel's wrapper checks
  its own outputs with :func:`check_kernel_outputs`, which names it.
  An Inf alone does not raise (an iteration may start from one, as in
  ``jax.debug_nans``); any arithmetic that turns it into a NaN does.
* :func:`check_finite` — explicit guard for user entry points.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
)
from torch.utils._pytree import tree_flatten

from ..errors import InvalidInput

__all__ = ["nan_debugging", "check_finite", "check_kernel_outputs"]

# Allocations: their outputs are uninitialized memory, not results.
_UNINITIALIZED = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided",
})


def _has_nan(t) -> bool:
    return (
        isinstance(t, torch.Tensor)
        and (t.is_floating_point() or t.is_complex())
        and bool(torch.isnan(t).any())
    )


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        checked = not (
            func.is_view or func.overloadpacket.__name__ in _UNINITIALIZED
        )
        if checked and any(_has_nan(t) for t in tree_flatten(out)[0]):
            raise FloatingPointError(
                f"invalid value (nan) encountered in {func}"
            )
        return out


def _active() -> bool:
    return any(isinstance(m, _NanCheck)
               for m in _get_current_dispatch_mode_stack())


@contextlib.contextmanager
def nan_debugging():
    """Raise ``FloatingPointError`` at the first operation inside the
    block that produces a NaN (every operation's outputs are read on the
    host, so the block runs slower).

    >>> x = torch.tensor([1.0, 0.0])
    >>> with nan_debugging():
    ...     y = x * 2
    ...     x / x[1]
    Traceback (most recent call last):
    ...
    FloatingPointError: invalid value (nan) encountered in aten.div.Tensor
    """
    with _NanCheck():
        yield


def check_kernel_outputs(name: str, *outputs) -> None:
    """Inside :func:`nan_debugging`, raise ``FloatingPointError`` naming
    the kernel wrapper ``name`` when one of its ``outputs`` (written by
    the kernel, unseen by the mode) holds a NaN; outside it, nothing."""
    if _active() and any(_has_nan(t) for t in outputs):
        raise FloatingPointError(f"invalid value (nan) encountered in {name}")


def check_finite(x, what: str = "input") -> None:
    """Raise ``InvalidInput`` unless every value of ``x`` is finite.

    >>> check_finite(torch.tensor([1.0, float("inf")]), "x")
    Traceback (most recent call last):
    ...
    petal_decomposition_tpu_torch.errors.InvalidInput: invalid matrix: x contains non-finite values
    """
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    if not bool(torch.isfinite(t).all()):
        raise InvalidInput(f"{what} contains non-finite values")
