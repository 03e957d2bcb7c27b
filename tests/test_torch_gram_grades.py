"""The ``gram_precision`` grade table (``ops/gram.py``): for every setting,
dtype, device type and context, the resolved grade, its mean-domination
guard threshold, whether K1 may sketch at it, and the dtype a stream
carries its Gram in."""

import itertools

import pytest
import torch

from petal_decomposition_tpu_torch.ops import gram as pgram

SETTINGS = ("auto", "default", "high", "highest")
DTYPES = (torch.float32, torch.float64)
DEVICE_TYPES = ("cpu", "cuda")
CONTEXTS = ("in_core", "mixed", "stream")

# What "auto" resolves to, by context (in core: the mixed float64 finder
# or not; a stream: its dtype and device at the first chunk).
AUTO = {
    ("in_core", torch.float32, "cpu"): "default",
    ("in_core", torch.float32, "cuda"): "default",
    ("in_core", torch.float64, "cpu"): "default",
    ("in_core", torch.float64, "cuda"): "default",
    ("mixed", torch.float32, "cpu"): "highest",
    ("mixed", torch.float32, "cuda"): "highest",
    ("mixed", torch.float64, "cpu"): "highest",
    ("mixed", torch.float64, "cuda"): "highest",
    ("stream", torch.float32, "cpu"): "highest",
    ("stream", torch.float32, "cuda"): "high",
    ("stream", torch.float64, "cpu"): "highest",
    ("stream", torch.float64, "cuda"): "highest",
}
GUARD_RMAX = {"default": 2.0, "high": 1e3, "highest": 1e5}
K1_ALLOWED = {"default": True, "high": False, "highest": False}


@pytest.mark.parametrize("setting, dtype, device_type, context",
                         list(itertools.product(SETTINGS, DTYPES,
                                                DEVICE_TYPES, CONTEXTS)))
def test_grade_table(setting, dtype, device_type, context):
    grade = pgram.resolve(setting, dtype, device_type,
                          mixed=context == "mixed",
                          stream=context == "stream")
    want = AUTO[context, dtype, device_type] if setting == "auto" else setting
    assert grade == want
    assert pgram.guard_rmax(grade) == GUARD_RMAX[grade]
    assert pgram.k1_allowed(grade) is K1_ALLOWED[grade]
    carry = pgram.carry_dtype(grade, dtype, device_type)
    f32_carry = (grade == "default" and dtype == torch.float32
                 and device_type == "cuda")
    assert carry == (torch.float32 if f32_carry else torch.float64)


@pytest.mark.parametrize("setting", ["", "bf16", "HIGH", None])
def test_unknown_settings_raise(setting):
    with pytest.raises(ValueError, match="unknown gram precision"):
        pgram.check(setting)
    with pytest.raises(ValueError, match="unknown gram precision"):
        pgram.resolve(setting, torch.float32, "cuda", stream=True)
