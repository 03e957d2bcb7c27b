"""Operations of a ``FastIca`` fit, counted for the work and not for the
kernels that do it.

The whitening: the means (n·d), the centered Gram (n·d·(d + 1), symmetric,
counted once), its d × d eigendecomposition and X₁ = K·Xcᵀ (2·k·d·n).
Each iteration: the two k-row products over n, W·X₁ and g(WX₁)·X₁ᵀ
(4·k²·n), the contrast's g′ row sums (2·k·n), and the symmetric
decorrelation by its eigendecomposition: W·Wᵀ (2k³), the eigh (9k³) and
V·Λ^(−1/2)·Vᵀ·W (4k³).  A fit is counted at the iterations it took.
An operation is one floating-point add or multiply.
"""

from __future__ import annotations

EIGH = 9  # k³ multiples of a symmetric eigendecomposition with vectors


def whitening_ops(n: int, d: int, k: int) -> float:
    return float(n * d + n * d * (d + 1) + EIGH * d ** 3 + 2 * k * d * n)


def iteration_ops(n: int, k: int) -> float:
    return float(4 * k * k * n + 2 * k * n + (2 + EIGH + 4) * k ** 3)


def fit_ops(cfg: dict, entry: str, n_iter) -> float:
    n, d = int(cfg["data"]["n"]), int(cfg["data"]["d"])
    k = int(cfg["model"].get("n_components") or min(n, d))
    # The first decorrelation of W₀ is one more decorrelation.
    return (whitening_ops(n, d, k) + int(n_iter) * iteration_ops(n, k)
            + (2 + EIGH + 4) * k ** 3)
