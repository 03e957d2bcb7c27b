"""K6: the sums of one FastICA step, ``g(W·X₁)·X₁ᵀ`` and the row sums of
``g′(W·X₁)``, in one pass over X₁.

It replaces no TPU kernel: the JAX package runs the two products, the
contrast and the row sums as XLA ops inside its ``lax.while_loop``, where
they cost no launches.  The port's loop runs on the host, where they were
seven launches a step (two IEEE-float32 cuBLAS matmuls, the contrast's
elementwise kernels and a row reduction) that wrote and re-read three
k×n temporaries.  The kernel (``csrc/ica_sums.cu``: one cooperative
launch of persistent CTAs over column blocks of X₁ fed by a ``cp.async``
ring, W in shared memory, both products on the tensor cores, g and g′ in
registers, each group's partial ``g·X_blkᵀ`` in registers; after a grid
barrier the CTAs sum the partials in a fixed order) computes

    gx   = g(W·X₁)·X₁ᵀ        (k×k)
    gsum = Σ_cols g′(W·X₁)    (k)

— ``models/fast_ica.py::_block_sums``, neither scaled by 1/n, for the
three contrasts — at float32 grade as K5 (``gram_syrk``) does: each
product as three TF32 products of the operands' hi/lo split, the tensor
cores' sums added into float32 every 64 terms.  The elementwise contrast
rounds as PyTorch's (``tanhf`` for logcosh); the sums run in another
order, with no atomics, so a repeated call gives the same bits.  Its
bound is operations: 4·k²·n float32 operations at 67 TFLOP/s, 24.5 µs at
k = 64, n = 100,000, against 7.6 µs to read X₁ at 3.35 TB/s.

On a CUDA tensor the wrapper launches it (or raises); on a CPU tensor it
runs :func:`_ica_sums_plain`, the host loop's arithmetic in PyTorch.
:func:`supports` is the operands the kernel takes; ``calls`` counts the
sums computed here on either path, ``launches`` the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils import debugging
from . import _build

__all__ = ["ica_sums", "supports", "build", "calls", "launches", "K_MAX",
           "CONTRASTS"]

# The largest k: at k = 128 W (rows padded to k + 4), two X blocks and a g
# block of 128 × 64 floats fill 172 KiB of a CTA's shared memory, and the
# partial g·Xᵀ and a block's tensor-core sums are 64 registers a thread each.
K_MAX = 128

# The contrasts in the kernel's order (its template parameter).
CONTRASTS = ("logcosh", "exp", "cube")
_CONTRAST_INDEX = {name: i for i, name in enumerate(CONTRASTS)}

# Resident CTAs an SM at most (``kMaxCtasPerSm``), and the columns of X₁
# a block (``kBn``): a launch has at most one CTA, so one partial, for
# each of either.
_CTAS_PER_SM = 2
_BLOCK_COLS = 64

calls = 0
launches = 0

_lib: ctypes.CDLL | None = None
_sms: dict[int, int] = {}


def supports(w: torch.Tensor, x: torch.Tensor) -> bool:
    """True when K6 takes the sums of ``w`` over ``x``: a square real
    float32 W on a CUDA device with 1 ≤ k ≤ ``K_MAX``, and X₁ a float32
    k × n matrix on W's device with unit column stride."""
    # The loop asks once a step, so this reads no torch.device objects.
    return (w.is_cuda and w.dtype == torch.float32
            and x.dtype == torch.float32 and w.dim() == 2 and x.dim() == 2
            and 1 <= w.size(0) <= K_MAX and w.size(1) == w.size(0)
            and x.size(0) == w.size(0) and x.get_device() == w.get_device()
            and (x.stride(1) == 1 or x.size(1) <= 1))


def build() -> ctypes.CDLL:
    """Compile (at first use) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = _build.load_library("petal_ica_sums", ("ica_sums.cu",))
        fn = lib.petal_ica_sums_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _ica_sums_plain(w: torch.Tensor, x: torch.Tensor, fun: str):
    """The kernel's function in PyTorch: ``(G·Xᵀ, g′ row sums)``,
    operation for operation the host loop's ``_step`` sums."""
    # Lazy: the models import this module.
    from ...models.fast_ica import _contrast_sums
    from ..linalg import mdot

    gwtx, gsum = _contrast_sums(fun, mdot(w, x))
    return mdot(gwtx, x.mT), gsum


def ica_sums(w: torch.Tensor, x: torch.Tensor, fun: str = "logcosh"):
    """``(gx, gsum)`` of one FastICA step: ``gx`` = g(W·X₁)·X₁ᵀ (k×k)
    and ``gsum`` the k row sums of g′(W·X₁), for the float32 k×k ``w``
    and k × n ``x`` and the contrast ``fun``; both on ``w``'s device.

    A CUDA ``w`` launches the kernel and raises where :func:`supports`
    does not hold or the launch is refused; a CPU ``w`` runs
    :func:`_ica_sums_plain`."""
    f = _CONTRAST_INDEX.get(fun)
    if f is not None and w.is_cuda and supports(w, x):
        return _launch(w, x, f)
    return _checked(w, x, fun)


def _checked(w: torch.Tensor, x: torch.Tensor, fun: str):
    """:func:`ica_sums` on operands the kernel does not take: the plain
    version on the CPU, else the error that names what is wrong."""
    global calls
    if fun not in CONTRASTS:
        raise ValueError(f"unknown contrast function {fun!r}")
    if w.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(
            f"ica_sums takes float32 operands, got {w.dtype} and {x.dtype}")
    k = w.shape[0] if w.dim() == 2 else -1
    if tuple(w.shape) != (k, k) or x.dim() != 2 or x.shape[0] != k:
        raise ValueError(
            f"ica_sums takes a square W and X₁ with its k rows; got "
            f"{tuple(w.shape)} and {tuple(x.shape)}")
    if x.device != w.device:
        raise ValueError(
            f"ica_sums' operands must share a device: W on {w.device}, "
            f"X₁ on {x.device}")
    if w.device.type == "cpu":
        calls += 1
        return _ica_sums_plain(w, x, fun)
    raise ValueError(
        f"a {k}x{k} W over a {tuple(x.shape)} X₁ with strides "
        f"{x.stride()} on {w.device} is outside K6's reach (CUDA, "
        f"1 <= k <= {K_MAX}, unit column stride)")


def _launch(w: torch.Tensor, x: torch.Tensor, f: int):
    """Launch K6 for contrast number ``f`` on operands :func:`supports`
    takes.  The host loop waits on this call once a step, so it reads the
    stream and the device by index and makes two views of one buffer."""
    global calls, launches
    k, n = x.shape
    index = w.get_device()
    sms = _sms.get(index)
    if sms is None:
        sms = _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    nparts = max(1, min(-(-n // _BLOCK_COLS), _CTAS_PER_SM * sms))
    count = k * k + k
    if not w.is_contiguous():
        w = w.contiguous()
    # One buffer: the result (gx, then gsum), then the CTAs' partials.
    buf = torch.empty(((nparts + 1) * count,), dtype=torch.float32,
                      device=w.device)
    lib = build()
    args = (w.data_ptr(), x.data_ptr(), x.stride(0) if k > 1 else n, k, n,
            f, sms, nparts, buf.data_ptr(), buf.data_ptr() + 4 * count)
    if torch.cuda.current_device() == index:
        status = lib.petal_ica_sums_f32(
            *args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            status = lib.petal_ica_sums_f32(
                *args, torch._C._cuda_getCurrentRawStream(index))
    _build.check(lib, status, "petal_ica_sums_f32 kernel launch")
    calls += 1
    launches += 1
    gx = buf.as_strided((k, k), (k, 1))
    gsum = buf.as_strided((k,), (1,), k * k)
    debugging.check_kernel_outputs("ica_sums (K6)", gx, gsum)
    return gx, gsum
