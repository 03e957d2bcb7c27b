"""The Gram ``XᵀX`` and the rules of its ``gram_precision`` grades, each
written once.

:func:`gram` makes every Gram of the port: K5
(:mod:`.kernels.gram_syrk`, 3×TF32 with float32 chunk sums) where
``gram_syrk.supports`` takes the matrix, else the IEEE float32 matmul
(:func:`.linalg.ieee_f32`); float64 stays float64.  ``matmul_calls``
counts the Grams the matmul made, as ``gram_syrk.calls`` counts K5's,
so each Gram is counted once by one of the two.  Every grade runs that
arithmetic.  The grade names (``"default"``, ``"high"``,
``"highest"``, and ``"auto"``, which :func:`resolve` turns into one of
them) still select three things:

* the mean-domination guard's threshold (:func:`guard_rmax`), the JAX
  package's ratings for one bf16 pass, conservative at float32;
* whether K1 may sketch (:func:`k1_allowed`: ``"default"`` only);
* the stream's carry (:func:`carry_dtype`).
"""

from __future__ import annotations

import torch

from .kernels import gram_syrk
from .linalg import ieee_f32

__all__ = ["GRADES", "gram", "matmul_calls", "check", "resolve",
           "guard_rmax", "k1_allowed", "carry_dtype"]

GRADES = ("default", "high", "highest")

# The fused centered Gram XᵀX − n·μμᵀ loses ~(1 + r) of its input grade
# at r = n‖μ‖²/tr(Gc); past these ratios it is recomputed from an
# explicitly centered copy (a stream, which cannot, raises).
_GUARD_RMAX = {"default": 2.0, "high": 1e3, "highest": 1e5}

matmul_calls = 0


def gram(x: torch.Tensor) -> torch.Tensor:
    """``xᵀx``: K5 where :func:`.kernels.gram_syrk.supports` holds, else
    the IEEE float32 matmul (float64 ``x`` stays float64), counted in
    ``matmul_calls``."""
    global matmul_calls
    if gram_syrk.supports(x):
        return gram_syrk.gram_syrk(x)
    matmul_calls += 1
    with ieee_f32():
        return x.mT @ x


def check(setting: str) -> None:
    """Raise ``ValueError`` unless ``setting`` is ``"auto"`` or a grade."""
    if setting != "auto" and setting not in GRADES:
        raise ValueError(f"unknown gram precision {setting!r}")


def resolve(setting: str, dtype: torch.dtype, device_type: str, *,
            mixed: bool = False, stream: bool = False) -> str:
    """The grade of ``setting``, checked, with ``"auto"`` resolved as the
    JAX package does: in core ``"highest"`` for the mixed float64 finder,
    else ``"default"``; in a stream (at its first chunk) ``"high"`` for
    float32 off the CPU, else ``"highest"``."""
    check(setting)
    if setting != "auto":
        return setting
    if stream:
        return ("high" if dtype == torch.float32 and device_type != "cpu"
                else "highest")
    return "highest" if mixed else "default"


def guard_rmax(grade: str) -> float:
    """The largest mean-domination ratio the grade's fused centering
    takes."""
    return _GUARD_RMAX[grade]


def k1_allowed(grade: str) -> bool:
    """Whether the fused sketch+moments kernel (K1) may run at the grade:
    its bf16×3 sketch is rated for ``"default"`` only."""
    return grade == "default"


def carry_dtype(grade: str, dtype: torch.dtype,
                device_type: str) -> torch.dtype:
    """The dtype a stream carries its Gram in and sums each chunk's
    moments in: float32 for ``"default"`` on float32 data off the CPU
    (the JAX package's rule, which its TPU's emulated float64 add set),
    else float64."""
    if grade == "default" and dtype == torch.float32 and device_type != "cpu":
        return torch.float32
    return torch.float64
