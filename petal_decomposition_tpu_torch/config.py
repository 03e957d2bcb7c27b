"""Global configuration of the PyTorch port.

The counterpart of ``petal_decomposition_tpu/config.py``, reduced to
the fields the PCA fits read:

* ``linalg_backend``:
    - ``"auto"``   — per-dtype dispatch: float64 uses the in-house Jacobi
      SVD (the 1e-10 parity route on every device: K3 on CUDA); float32
      uses it on CUDA (K2) and ``torch.linalg`` (LAPACK) on the CPU;
      complex always uses ``torch.linalg``.
    - ``"jacobi"`` — always use the in-house Jacobi SVD.
    - ``"torch"``  — always use ``torch.linalg`` (the counterpart of the
      JAX package's ``"xla"``).
    - ``"native"`` — the host C++ core (``native/petal_native.cpp``,
      :mod:`.utils.native`) for real SVDs and eighs and the exact
      ``Pca`` fit; the library is built at first use, and a failed build
      raises.
* ``jacobi_max_sweeps`` / ``check_convergence``: the Jacobi sweep budget
  and whether an unconverged certificate raises ``LinalgError``.
* ``host_offload_max_elements``: under ``"auto"``, real factorizations
  of tensors on the card with at most this many elements run on the
  host C++ core instead (the fit is then bound by launch latency, not
  arithmetic).  0, the JAX package's default, turns it off; whether it
  pays on a card is measured by ``chip_smoke.py`` (phase
  ``native_offload``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

__all__ = ["config", "Config"]


@dataclass
class Config:
    linalg_backend: str = "auto"  # "auto" | "jacobi" | "torch" | "native"
    # Max Jacobi sweeps before declaring non-convergence (LinalgError
    # analogue of LAPACK info != 0; ref: linalg.rs:84).
    jacobi_max_sweeps: int = 30
    check_convergence: bool = True
    host_offload_max_elements: int = 0

    def validate(self) -> None:
        if self.linalg_backend not in ("auto", "jacobi", "torch", "native"):
            raise ValueError(f"unknown linalg backend: {self.linalg_backend}")


config = Config(
    linalg_backend=os.environ.get("PETAL_LINALG_BACKEND", "auto"),
)
config.validate()
