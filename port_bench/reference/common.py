"""Precisions of the references, and the seed contract the models state.

A reference runs in ``"float64"``, ``"float32"`` (IEEE products, TF32
off) or ``"tf32"``: float32 whose products take operands rounded to
TF32's 10-bit mantissa and accumulate in float32, as the card's TF32
tensor cores do.  ``"tf32"`` is written out so that it reads the same on
the CPU as on the card.

The models seed their draws by the contract of the program's
``utils/rng.py``, which this file writes out again: a u128 seed mixed by
SplitMix64 into a CPU ``torch.Generator``; each fit splits one child off
it and draws its Gaussian there, at the data's dtype.
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("float64", "float32", "tf32")

_MASK64 = (1 << 64) - 1
_MASK32 = (1 << 32) - 1


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return torch.float64 if precision == "float64" else torch.float32


@contextlib.contextmanager
def no_tf32():
    """IEEE float32 products on the card for the block, whatever the
    process set."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    p = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(p)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at TF32's 10 explicit
    mantissa bits.

    >>> round_tf32(torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11])).tolist()
    [1.0, 1.001953125]
    """
    i = x.contiguous().view(torch.int32)
    i = i + 0xFFF + ((i >> 13) & 1)
    return (i & -0x2000).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` at ``precision`` (operands already at its dtype)."""
    if precision == "tf32":
        return round_tf32(a) @ round_tf32(b)
    return a @ b


def _mix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def model_generator(seed: int) -> torch.Generator:
    """The CPU generator a model seeded with ``seed`` starts from."""
    seed = int(seed)
    state = _mix64(seed & _MASK32)
    rest = seed >> 32
    while rest:
        state = _mix64(state ^ (rest & _MASK32))
        rest >>= 32
    return torch.Generator().manual_seed(state)


def split(gen: torch.Generator) -> torch.Generator:
    """The child generator one fit splits off ``gen``."""
    child = int(torch.randint(0, 1 << 62, (1,), generator=gen,
                              dtype=torch.int64))
    return torch.Generator().manual_seed(_mix64(child))


def fit_draws(seed: int, fits, shape, dtype: torch.dtype) -> dict:
    """``{fit: Gaussian}``: the draw of each numbered fit (0 is the
    model's first) of a model seeded with ``seed``, on the CPU."""
    gen = model_generator(seed)
    want = set(fits)
    out = {}
    for i in range(max(want) + 1):
        sub = split(gen)
        if i in want:
            out[i] = torch.randn(shape, generator=sub, dtype=dtype)
    return out
