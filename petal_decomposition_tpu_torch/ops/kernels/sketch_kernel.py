"""K1: the fused sketch + moments pass, ``(X·W, Σᵢ X[i,:], ‖X‖²_F)`` in
one read of X.

The port of ``petal_decomposition_tpu/ops/pallas/sketch_kernel.py``
(``fused_sketch_moments``).  The product is the TPU kernel's bf16×3
split, ``xh·wh + xl·wh + xh·wl`` with float32 accumulation.  On a CUDA
tensor the wrapper launches the hand-written Hopper kernel
``csrc/sketch_moments.cu`` (TMA-fed ``wgmma``); on a CPU tensor it runs
:func:`_sketch_moments_plain`, the same split product as three float32
matmuls.  ``launches`` counts kernel launches.  On a mesh,
:func:`fused_sketch_moments_on` launches K1 on every row shard and
reduces the moments over the shards (the JAX ``shard_map`` + ``psum``);
it has no availability probe and no kernel-free fallback.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils import debugging
from . import _build

__all__ = ["fused_sketch_moments", "fused_sketch_moments_on", "supports",
           "build", "launches"]

# Smallest row count the fused pass is used for, as in the JAX package
# (four of its 1024-row blocks): below it the saved pass is noise.
_MIN_ROWS = 4096

launches = 0


def supports(n: int, d: int, l: int, dtype) -> bool:
    """True when the fused pass takes the problem: float32 data, a
    sketch 1..512 wide, and at least 4096 rows.

    The gate is the port's own, set by the card: the kernel streams X in
    32-column tiles, so any ``d`` fits.  It is not the JAX package's,
    whose block height comes from a 12 MB TPU VMEM budget; the two
    differ at large ``d`` (at (2048, 4096, 42) the JAX gate takes the
    problem and this one does not, at (8192, 20000, 42) the reverse)."""
    return dtype == torch.float32 and 1 <= l <= 512 and d >= 1 and (
        n >= _MIN_ROWS
    )


def build() -> ctypes.CDLL:
    """Compile (at first use) and load the kernel library."""
    lib = _build.load_library("petal_sketch_moments", ("sketch_moments.cu",))
    fn = lib.petal_sketch_moments_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.petal_sketch_grid.argtypes = [ctypes.c_int64, ctypes.c_int,
                                      ctypes.c_int]
    lib.petal_sketch_grid.restype = ctypes.c_int
    lib.petal_sketch_wpre_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.petal_sketch_wpre_bytes.restype = ctypes.c_int64
    return lib


def _split_bf16(a: torch.Tensor):
    """``(hi, lo)`` bf16 halves of float32 ``a``, as the TPU kernel splits
    (``astype(bfloat16)``, round to nearest even): ``hi`` is ``a`` rounded,
    ``lo`` the remainder rounded."""
    hi = a.to(torch.bfloat16)
    return hi, (a - hi.float()).to(torch.bfloat16)


def _sketch_moments_plain(x: torch.Tensor, w: torch.Tensor):
    """``(xh·wh + xl·wh + xh·wl, x.sum(0), (x * x).sum())``: the kernel's
    bf16×3 split product, each split upcast to float32 for its matmul
    (a bf16 matmul would round its result to bf16)."""
    from ..linalg import mdot

    xh, xl = (t.float() for t in _split_bf16(x))
    wh, wl = (t.float() for t in _split_bf16(w))
    y = mdot(xh, wh) + mdot(xl, wh) + mdot(xh, wl)
    return y, x.sum(0), (x * x).sum()


def fused_sketch_moments(x: torch.Tensor, w: torch.Tensor):
    """``(Y, colsum, sqnorm)`` in one pass over ``x``: ``Y = x @ w`` as
    the bf16×3 split product, ``colsum`` (d,) and the 0-d ``sqnorm`` summed in float64
    and rounded to float32.  ``x`` is (n, d) and ``w`` (d, l), both
    contiguous float32 on one device (``x`` may start at any 4-byte
    offset); callers gate on :func:`supports`.

    CUDA tensors launch the kernel (and raise if it cannot be built or
    launched); CPU tensors run :func:`_sketch_moments_plain`.
    """
    global launches
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(
            f"shapes {tuple(x.shape)} and {tuple(w.shape)} do not chain"
        )
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError("fused_sketch_moments takes float32 operands")
    if x.device != w.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    n, d = x.shape
    l = w.shape[1]
    if not supports(n, d, l, x.dtype):
        raise ValueError(f"unsupported problem n={n} d={d} l={l}")
    if x.device.type == "cpu":
        return _sketch_moments_plain(x, w)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("fused_sketch_moments takes contiguous operands")
    lib = build()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid = lib.petal_sketch_grid(n, l, sms)
    dev = x.device
    y = torch.empty((n, l), dtype=torch.float32, device=dev)
    colsum = torch.empty((d,), dtype=torch.float32, device=dev)
    sqnorm = torch.empty((1,), dtype=torch.float32, device=dev)
    # The pre-split W (bf16 hi/lo in the wgmma layout) and the float64
    # partial moments: one row of column sums per consumer warpgroup.
    wpre = torch.empty((lib.petal_sketch_wpre_bytes(d, l),),
                       dtype=torch.uint8, device=dev)
    cs_part = torch.zeros((2 * grid, d), dtype=torch.float64, device=dev)
    sq_part = torch.empty((grid,), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.petal_sketch_moments_f32(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), wpre.data_ptr(),
            cs_part.data_ptr(), sq_part.data_ptr(), colsum.data_ptr(),
            sqnorm.data_ptr(), n, d, l, grid, stream,
        )
    _build.check(lib, status, "sketch_moments kernel launch")
    launches += 1
    debugging.check_kernel_outputs("fused_sketch_moments (K1)", y, colsum,
                                   sqnorm)
    return y, colsum, sqnorm[0]


def fused_sketch_moments_on(xs, w: torch.Tensor):
    """:func:`fused_sketch_moments` on every row shard of ``xs``
    (``parallel.mesh.Rows``): ``(Y, colsum, sqnorm)`` with Y row-sharded
    as ``xs`` and the two moments reduced over the shards of its mesh
    (``parallel.distributed.psum``).  Zero-padded rows add nothing to any
    output, so padding needs no mask here.  Callers gate on
    :func:`supports` at the rows of one shard.

    >>> from petal_decomposition_tpu_torch.parallel.mesh import (
    ...     make_mesh, shard_rows_padded)
    >>> g = torch.Generator().manual_seed(0)
    >>> x = torch.randn(8200, 16, generator=g)
    >>> w = torch.randn(16, 4, generator=g)
    >>> xs, n = shard_rows_padded(x, make_mesh(2, devices=["cpu"] * 2))
    >>> ys, cs, sq = fused_sketch_moments_on(xs, w)
    >>> len(ys.shards), tuple(ys.shape)
    (2, (8200, 4))
    >>> bool(torch.allclose(cs, x.sum(0), rtol=1e-5, atol=1e-3))
    True
    """
    from ...parallel.distributed import psum
    from ...parallel.mesh import Rows

    outs = [fused_sketch_moments(s, wd)
            for s, (wd,) in zip(xs.shards, xs.on_devices(w))]
    ys = Rows([o[0] for o in outs], xs.mesh, xs.n_valid, xs.rows_per_shard)
    return (ys, psum([o[1] for o in outs], xs.mesh),
            psum([o[2] for o in outs], xs.mesh))
