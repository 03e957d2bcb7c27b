"""Hi/lo-split float32 products for float64 operands ("ds64") — the
counterpart of ``petal_decomposition_tpu/ops/splitmm.py``.

The FastICA ``iteration_precision="f32"`` path (``models/fast_ica.py``)
runs a middle stage whose two k×n products take float64 operands as
float32 (hi, lo) pairs with ``x == hi + lo`` to ~2⁻⁴⁸ relative:

    A·B ≈ Ah·Bh + Ah·Bl + Al·Bh        (Al·Bl ~ 2⁻⁴⁸, dropped)

* short contraction (k-length, W·X): plain float32 accumulation;
* long contraction (n-length, G·Xᵀ): the contraction is cut into
  ``chunk``-sized pieces accumulated in float32, and the per-chunk
  partials are summed in float64.

Every product here is an IEEE float32 matmul (``linalg.mdot``, TF32
off), as the JAX package's are at ``precision="highest"``.  The stage
exists because a TPU emulates float64 products; whether it pays on a
card with native float64 is measured, not assumed (``PERF.md``).
"""

from __future__ import annotations

import torch

from .linalg import ieee_f32, mdot

__all__ = ["split_f64", "mm_split_f32", "mm_split_chunked_f64"]


def split_f64(x: torch.Tensor):
    """Split a float64 tensor into (hi, lo) float32 with x == hi + lo
    exactly in float64 up to the float32 underflow floor.

    >>> hi, lo = split_f64(torch.tensor(3.141592653589793, dtype=torch.float64))
    >>> bool(abs(float(hi.double() + lo.double()) - 3.141592653589793) < 1e-14)
    True
    """
    x = x.to(torch.float64)
    hi = x.to(torch.float32)
    lo = (x - hi.to(torch.float64)).to(torch.float32)
    return hi, lo


def mm_split_f32(a64: torch.Tensor, bh: torch.Tensor, bl: torch.Tensor):
    """``a64 @ (bh + bl)`` to ~1.5e-7 normwise, returned in float32.

    ``a64`` is float64 (split here); ``(bh, bl)`` a pre-split right
    operand (:func:`split_f64`).  Three float32 products with plain
    float32 accumulation, for short contractions (the FastICA W·X
    product, contraction = k).
    """
    ah, al = split_f64(a64)
    main = mdot(ah, bh)
    cross = mdot(ah, bl) + mdot(al, bh)
    return main + cross


def mm_split_chunked_f64(g32: torch.Tensor, bh: torch.Tensor,
                         bl: torch.Tensor, *, chunk: int = 512):
    """``g32 @ (bh + bl).T`` contracted over the long (last) axis,
    carried in float64.

    ``g32``: (k, n) float32; ``(bh, bl)``: (k2, n) pre-split float64
    right operand.  The main ``g32·bhᵀ`` pass is chunked along n: each
    ``chunk``-length slice accumulates in float32 and the per-chunk
    partials sum in float64; below two chunks it is one product.  The lo
    cross term is ~2⁻²⁴ smaller and accumulates unchunked.
    """
    if g32.dtype != torch.float32:
        # A float64 left operand would promote every pass to a float64
        # product, defeating the split; the caller evaluates g in float32.
        raise TypeError(f"g32 must be float32, got {g32.dtype}")
    k, n = g32.shape
    k2 = bh.shape[0]
    nb = n // chunk
    if nb >= 2:
        g3 = g32[:, : nb * chunk].reshape(k, nb, chunk).transpose(0, 1)
        b3 = bh[:, : nb * chunk].reshape(k2, nb, chunk).permute(1, 2, 0)
        with ieee_f32():
            parts = torch.bmm(g3, b3)  # (nb, k, k2)
        main = parts.to(torch.float64).sum(0)
        tail = mdot(g32[:, nb * chunk:], bh[:, nb * chunk:].mT)
        main = main + tail.to(torch.float64)
    else:
        main = mdot(g32, bh.mT).to(torch.float64)
    cross = mdot(g32, bl.mT)
    return main + cross.to(torch.float64)
