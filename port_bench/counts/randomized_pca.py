"""Operations and bytes of a ``RandomizedPca`` fit, counted for the work
and not for the kernels that do it.

The route counted is the one the card runs today at the configuration's
shapes: the Gram range finder with the zero-pass Gram recovery
(``parallel/distributed.py::_resolve_gram_projection``).  A fit needs the
moments pass (column sums, ‖X‖², the symmetric Gram, counted once:
n·d·(d + 1)), the subspace iteration on the d × d Gram (q products and
q + 1 thin QRs of d × l), the recovery (G·W, WᵀGW, (GW)ᵀGW, two l × l
eighs, the l × l products and the last thin QR) and, for ``fit``, the
thin U = Xc·V·Σ⁻¹, which reads X again.  ``fit_batched`` forms no U.
An operation is one floating-point add or multiply.
"""

from __future__ import annotations

EIGH = 9  # l³ multiples of a symmetric eigendecomposition with vectors


def qr_ops(m: int, l: int) -> float:
    """A thin Householder QR of m × l with Q formed."""
    return 4 * m * l * l - 4 * l ** 3 / 3


def moments_ops(n: int, d: int) -> float:
    """Column sums (n·d), ‖X‖² (2·n·d) and the Gram (n·d·(d + 1))."""
    return n * d * (d + 1) + 3 * n * d


def solve_ops(d: int, l: int, q: int) -> float:
    """The subspace iteration and the zero-pass recovery on the Gram."""
    subspace = q * 2 * d * d * l + (q + 1) * qr_ops(d, l)
    recovery = (2 * d * d * l + 2 * 2 * d * l * l + 2 * EIGH * l ** 3
                + 2 * 2 * l ** 3 + 2 * l ** 3 + 2 * d * l * l + qr_ops(d, l))
    return subspace + recovery


def fit_ops(cfg: dict, entry: str, n_iter=None) -> float:
    """The operations of one fit of ``entry`` (``"fit"`` or
    ``"fit_batched"``) at the configuration's shapes."""
    n, d = int(cfg["data"]["n"]), int(cfg["data"]["d"])
    m = cfg["model"]
    k = int(m["n_components"])
    l = min(k + int(m.get("n_oversamples", 10)), n, d)
    q = int(m.get("n_power_iters", 7))
    ops = moments_ops(n, d) + solve_ops(d, l, q)
    if entry == "fit":
        ops += 2 * n * d * l + 2 * n * l
    return float(ops)


def gram_pass_ops(n: int, d: int) -> float:
    """The moments pass alone: the symmetric Gram counted once, the sums."""
    return float(moments_ops(n, d))


def gram_pass_bytes(n: int, d: int, itemsize: int) -> float:
    """X read once, the d × d Gram written once."""
    return float(n * d * itemsize + d * d * itemsize)
