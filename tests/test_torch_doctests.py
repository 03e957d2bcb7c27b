"""The PyTorch port's docstring examples run as tests."""

import doctest
import importlib

import pytest

_MODULES = [
    "petal_decomposition_tpu_torch",
    "petal_decomposition_tpu_torch.models.fast_ica",
    "petal_decomposition_tpu_torch.models.pca",
    "petal_decomposition_tpu_torch.models.randomized_pca",
    "petal_decomposition_tpu_torch.ops.centered",
    "petal_decomposition_tpu_torch.ops.gram_recovery",
    "petal_decomposition_tpu_torch.ops.linalg",
    "petal_decomposition_tpu_torch.ops.splitmm",
    "petal_decomposition_tpu_torch.utils.profiling",
    "petal_decomposition_tpu_torch.utils.rng",
]


@pytest.mark.parametrize("name", _MODULES)
def test_doctests(name):
    mod = importlib.import_module(name)
    result = doctest.testmod(mod, verbose=False)
    assert result.attempted > 0
    assert result.failed == 0
