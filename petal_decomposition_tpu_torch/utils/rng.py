"""Seed handling.

The counterpart of ``petal_decomposition_tpu/utils/rng.py``.  The
reference seeds a PCG generator from a ``u128`` (ref: pca.rs:357); what
both packages preserve is the *contract*: a 128-bit seed
deterministically selects the stream, and successive fits on one model
advance it.

A u128 seed becomes a CPU ``torch.Generator`` whose 64-bit seed mixes
all four 32-bit limbs.  :func:`split` plays the role of
``jax.random.split``: it advances the parent by one draw and returns an
independent child.  :func:`normal` draws on the CPU generator and moves
the result to the target device, so one seed gives the same Gaussian on
the CPU and on CUDA (Ω is d×l, a negligible transfer).
"""

from __future__ import annotations

import secrets

import torch

__all__ = ["generator_from_seed", "split", "random_seed", "normal"]

_MASK64 = (1 << 64) - 1
_MASK32 = (1 << 32) - 1


def _mix64(z: int) -> int:
    """SplitMix64 finalizer: a bijective 64-bit scramble."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def generator_from_seed(seed: int) -> torch.Generator:
    """A CPU generator from an arbitrary-width integer seed (u128 in the
    reference API, ref: pca.rs:356-359); every 32-bit limb participates.

    >>> a = torch.randn(3, generator=generator_from_seed(1 << 100))
    >>> b = torch.randn(3, generator=generator_from_seed(1 << 101))
    >>> bool(torch.equal(a, b))
    False
    """
    seed = int(seed)
    if seed < 0:
        raise ValueError("seed must be non-negative")
    state = _mix64(seed & _MASK32)
    rest = seed >> 32
    while rest:
        state = _mix64(state ^ (rest & _MASK32))
        rest >>= 32
    gen = torch.Generator()
    gen.manual_seed(state)
    return gen


def split(gen: torch.Generator) -> torch.Generator:
    """Advance ``gen`` by one draw and return a child generator seeded
    from it (the ``jax.random.split`` role)."""
    child_seed = int(
        torch.randint(0, 1 << 62, (1,), generator=gen, dtype=torch.int64)
    )
    child = torch.Generator()
    child.manual_seed(_mix64(child_seed))
    return child


def random_seed() -> int:
    """A randomly-generated 128-bit seed (analogue of
    ``rand::rng().random()`` at pca.rs:343)."""
    return secrets.randbits(128)


def normal(gen: torch.Generator, shape, dtype: torch.dtype,
           device) -> torch.Tensor:
    """Standard-normal draws of ``shape`` and ``dtype`` on ``device``,
    taken from the CPU generator ``gen``.  A complex dtype draws the real
    Gaussian of its real dtype and widens it, imaginary part zero, as
    the reference's complex models do (pca.rs:701-705).

    >>> w = normal(generator_from_seed(7), (2, 2), torch.complex128, "cpu")
    >>> w.dtype, bool((w.imag == 0).all())
    (torch.complex128, True)
    """
    real = dtype.to_real() if dtype.is_complex else dtype
    return torch.randn(shape, generator=gen, dtype=real).to(device, dtype)
