"""The PyTorch port imports neither JAX nor Triton, its public surface,
and its default device."""

import subprocess
import sys

import numpy as np
import pytest
import torch

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
        "FastIca", "FastIcaBuilder", "DecompositionError", "InvalidInput",
        "LinalgError",
    }
    assert pt.__version__
    # Same taxonomy and messages as the JAX package's errors.
    assert issubclass(pt.InvalidInput, pt.DecompositionError)
    assert issubclass(pt.LinalgError, pt.DecompositionError)
    assert str(pt.InvalidInput("x")) == str(jax_errors.InvalidInput("x"))
    assert str(pt.LinalgError("y")) == str(jax_errors.LinalgError("y"))


@pytest.mark.parametrize(
    "make",
    [
        lambda pt: pt.Pca(2),
        lambda pt: pt.Pca.new(2),
        lambda pt: pt.PcaBuilder(2).build(),
        lambda pt: pt.RandomizedPca(2, seed=0),
        lambda pt: pt.RandomizedPca.with_seed(2, 0),
        lambda pt: pt.RandomizedPcaBuilder(2).seed(0).build(),
    ],
    ids=["Pca", "Pca.new", "PcaBuilder", "RandomizedPca",
         "RandomizedPca.with_seed", "RandomizedPcaBuilder"],
)
def test_default_device_is_the_card(monkeypatch, make):
    """A model built without ``device=`` resolves to CUDA; on a machine
    with no card its fit raises instead of running on the CPU."""
    import petal_decomposition_tpu_torch as pt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = make(pt)
    assert model.device == torch.device("cuda")
    x = np.arange(24.0).reshape(8, 3) ** 1.5
    for fit in (model.fit, model.fit_transform):
        with pytest.raises(RuntimeError, match='pass device="cpu"'):
            fit(x)
    cpu = type(model)(2, device="cpu")
    assert cpu.fit_transform(x).shape == (8, 2)
