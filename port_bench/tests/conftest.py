"""Shared fixtures of the harness's tests: the repository's root, and a
cell cut to a size the CPU runs in a moment."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench.core import spec  # noqa: E402

TINY = {
    "randomized_pca": {"n": 8192, "d": 256, "gen_rows": 2048},
    "fast_ica": {"n": 4000, "d": 8, "sources": 8, "gen_rows": 1000},
}
SEED = 2 ** 31 + 12345  # more than 32 signed bits hold


def tiny_cell(name: str) -> spec.Cell:
    """The cell ``name`` with its data cut to ``TINY``'s shapes."""
    c = spec.cell(ROOT, spec.load(ROOT), name)
    c.config["data"].update(TINY[c.config["family"]])
    return c


@pytest.fixture
def root():
    return ROOT
