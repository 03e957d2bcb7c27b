"""K5: the Gram ``XᵀX`` of a float32 matrix at float32 grade, one
triangle, on Hopper's tensor cores.

It replaces no TPU kernel: the JAX package leaves the Gram range
finder's ``XᵀX`` to XLA.  The port ran it as ``xc.mT @ xc`` in IEEE float32, cuBLAS's SIMT sgemm:
both triangles of a symmetric result on the CUDA cores.  The kernel
(``csrc/gram_syrk.cu``: persistent CTAs over the upper-triangle 128 ×
128 tiles, TMA-fed ``wgmma`` m64n128k8 in TF32) splits each element as
``x = hi + lo``, ``hi = tf32(x)`` (round to nearest, ties away),
``lo = x − hi`` (which the tensor cores truncate to TF32), and sums
``hi·lo + lo·hi + hi·hi`` over a chunk of ``CHUNK_ROWS`` rows on the
tensor cores; each chunk's sum is added into a float32 sum with IEEE
round-to-nearest adds.  It writes the upper
triangle and its mirror, so G is whole and exactly symmetric, and gives
the same bits on every call.

On a CUDA tensor :func:`gram_syrk` launches the kernel (or raises); on a
CPU tensor it runs :func:`_gram_syrk_plain`, the same split and chunked
sums in PyTorch.  :func:`supports` is the matrices the kernel takes;
``calls`` counts the Grams computed here on either path, ``launches``
the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils import debugging
from . import _build

__all__ = ["gram_syrk", "supports", "build", "calls", "launches",
           "CHUNK_ROWS", "MIN_D", "MIN_ROWS"]

# Rows whose products the tensor cores sum before the sum is added into
# the float32 accumulator (a multiple of the kernel's 32-row stage).
CHUNK_ROWS = 128

# The tensor cores' chunk sums truncate, so K5's error has a floor of
# ≈ 1e-6 of the Gram whatever n is, where the IEEE matmul's grows with n
# from ≈ 1e-7.  Measured on an H100 against float64 Grams of three kinds
# of X (low rank, mean-shifted, mean-dominated), raw and centered, for n
# from 1024 to 1M (PERF.md §6, K5's grade): from 32,768 rows at d = 2048
# and 4096 every K5 reading is at most 0.89 times the matmul's; at 16,384
# one reads 1.7 times.  At d = 1024 and 1536 cuBLAS's matmul is the more
# exact up to 262,144 rows (K5 1.17 and 1.31 times there).  So K5 takes X
# from ``MIN_ROWS`` rows and ``MIN_D`` columns.
MIN_D = 2048
MIN_ROWS = 32768

# Rows past which the kernel's TMA row coordinate (an int32) would wrap.
_MAX_ROWS = 2**31 - 64

calls = 0
launches = 0

_sm90: dict[int, bool] = {}


def _is_sm90(device: torch.device) -> bool:
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    if index not in _sm90:
        _sm90[index] = torch.cuda.get_device_capability(index) == (9, 0)
    return _sm90[index]


def supports(x: torch.Tensor) -> bool:
    """True when K5 takes the Gram of ``x``: a real float32 2-D matrix on
    a CUDA card of compute capability 9.0, with unit column stride, a row
    stride and base 16-byte aligned, ``MIN_ROWS`` ≤ n < 2³¹ − 64 rows
    and at least ``MIN_D`` columns."""
    if not (x.is_cuda and x.dtype == torch.float32 and x.dim() == 2):
        return False
    n, d = x.shape
    return (MIN_D <= d and MIN_ROWS <= n <= _MAX_ROWS and x.stride(1) == 1
            and (n == 1 or (x.stride(0) >= d and x.stride(0) % 4 == 0))
            and x.data_ptr() % 16 == 0 and _is_sm90(x.device))


def build() -> ctypes.CDLL:
    """Compile (at first use) and load the kernel library."""
    lib = _build.load_library("petal_gram_syrk", ("gram_syrk.cu",))
    fn = lib.petal_gram_syrk_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.petal_gram_syrk_grid.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.petal_gram_syrk_grid.restype = ctypes.c_int
    return lib


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """``a`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``: half of the dropped 13 bits'
    range added to the magnitude, then the 13 bits cleared."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_truncated(a: torch.Tensor) -> torch.Tensor:
    """``a`` with its 13 low mantissa bits cleared: the TF32 value the
    tensor cores read from a float32 operand."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mirror_upper(g: torch.Tensor) -> torch.Tensor:
    """The upper triangle of ``g`` and its mirror: exactly symmetric."""
    upper = torch.triu(g)
    return upper + torch.triu(upper, 1).mT


def _gram_syrk_plain(x: torch.Tensor, chunk_rows: int = CHUNK_ROWS):
    """The kernel's arithmetic in PyTorch: ``hi`` = x rounded to TF32,
    ``lo`` = x − hi as the tensor cores read it (truncated to TF32); for
    each chunk of ``chunk_rows`` rows, ``(hiᵀlo + loᵀhi) + hiᵀhi`` in
    float32, added into a float32 sum; the upper triangle mirrored."""
    from ..linalg import ieee_f32

    d = x.shape[1]
    g = torch.zeros((d, d), dtype=torch.float32, device=x.device)
    with ieee_f32():
        for r0 in range(0, x.shape[0], chunk_rows):
            c = x[r0:r0 + chunk_rows]
            hi = _tf32(c)
            lo = _tf32_truncated(c - hi)
            g += (hi.mT @ lo + lo.mT @ hi) + hi.mT @ hi
    return _mirror_upper(g)


def gram_syrk(x: torch.Tensor) -> torch.Tensor:
    """``xᵀx`` (d × d float32) of the float32 n × d ``x``, on ``x``'s
    device.

    A CUDA ``x`` launches the kernel and raises where :func:`supports`
    does not hold or the launch is refused; a CPU ``x`` runs
    :func:`_gram_syrk_plain`."""
    global calls, launches
    if x.dim() != 2:
        raise ValueError(f"gram_syrk takes a matrix, got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"gram_syrk takes float32, got {x.dtype}")
    if x.device.type == "cpu":
        calls += 1
        return _gram_syrk_plain(x)
    if not supports(x):
        raise ValueError(
            f"a {tuple(x.shape)} matrix with strides {x.stride()} on "
            f"{x.device} is outside K5's reach (float32 on a compute "
            f"capability 9.0 card, unit column stride, 16-byte aligned "
            f"rows, n >= {MIN_ROWS}, d >= {MIN_D})")
    n, d = x.shape
    lib = build()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    g = torch.empty((d, d), dtype=torch.float32, device=x.device)
    ld = x.stride(0) if n > 1 else d + (-d) % 4
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.petal_gram_syrk_f32(
            x.data_ptr(), g.data_ptr(), n, d, ld,
            lib.petal_gram_syrk_grid(d, sms), CHUNK_ROWS, stream)
    _build.check(lib, status, "petal_gram_syrk_f32 kernel launch")
    calls += 1
    launches += 1
    debugging.check_kernel_outputs("gram_syrk (K5)", g)
    return g
