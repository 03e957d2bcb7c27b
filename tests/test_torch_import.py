"""The PyTorch port imports neither JAX nor Triton."""

import subprocess
import sys

_PROBE = """
import importlib, pkgutil, sys
import petal_decomposition_tpu_torch as pkg
for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(mod.name)
print(sorted(m for m in ("jax", "jaxlib", "triton", "petal_decomposition_tpu")
             if m in sys.modules))
"""


def test_port_imports_no_jax_or_triton():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        check=True, timeout=120,
    ).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_public_api():
    import petal_decomposition_tpu_torch as pt
    from petal_decomposition_tpu import errors as jax_errors

    assert set(pt.__all__) >= {
        "Pca", "PcaBuilder", "RandomizedPca", "RandomizedPcaBuilder",
        "DecompositionError", "InvalidInput", "LinalgError",
    }
    assert pt.__version__
    # Same taxonomy and messages as the JAX package's errors.
    assert issubclass(pt.InvalidInput, pt.DecompositionError)
    assert issubclass(pt.LinalgError, pt.DecompositionError)
    assert str(pt.InvalidInput("x")) == str(jax_errors.InvalidInput("x"))
    assert str(pt.LinalgError("y")) == str(jax_errors.LinalgError("y"))
