"""K4: one FastICA fixed-point update of a float32 k×k W, with its
Newton–Schulz symmetric decorrelation and the stop value, in one launch.

It replaces no TPU kernel: the JAX package runs the update and
``symmetric_decorrelation_ns`` as XLA ops inside its ``lax.while_loop``,
where they cost no launches.  The port's loop runs on the host, where
the same arithmetic was ≈ 160 launches a step, and those launches, not
the ≈ 39 MFLOP of a step at k = 64, held the card idle.  The kernel
(``csrc/ica_update.cu``: one thread block cluster of 8 CTAs, each
sending its row blocks into its peers' shared memory with ``st.async``
and waiting on mbarriers for the rows it reads) computes, in IEEE
float32:

1. ``W_new = gx·p_inv − ((gsum − pad_g0)·p_inv)[:, None]·W``
2. ``A = W_new·W_newᵀ``, ``c = trace(A)``, ``Y = A/c``, ``Z = I``
3. ``NS_ITERS`` times: ``T = 1.5·I − 0.5·(Z·Y)``, ``Y ← Y·T``,
   ``Z ← T·Z``
4. ``W1 = (Z·W_new)/√c``
5. ``lim = max_i | |row_i(W1)·col_i(W)| − 1 |``

— ``models/fast_ica.py::_update`` with ``symmetric_decorrelation_ns``,
every product and step kept, the sums inside a product in another order.
On a CUDA tensor the wrapper launches it (or raises); on a CPU tensor it
runs :func:`_ica_update_plain`, that arithmetic in PyTorch.
:func:`supports` is the tensors the kernel takes; ``launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils import debugging
from . import _build

__all__ = ["ica_update", "supports", "build", "launches", "K_MAX",
           "NS_ITERS"]

# The largest k whose three k×k float32 copies (Y, T, Z, rows padded to
# k + 4) and partial sums fit a CTA's 227 KB of shared memory: 222 KB at
# 128.
K_MAX = 128

# ``symmetric_decorrelation_ns``'s iteration count.
NS_ITERS = 24

launches = 0


def supports(w: torch.Tensor) -> bool:
    """True when K4 takes the update of ``w``: a square float32 matrix on
    a CUDA device with 1 ≤ k ≤ ``K_MAX``."""
    return (w.is_cuda and w.dtype == torch.float32 and w.dim() == 2
            and w.shape[0] == w.shape[1] and 1 <= w.shape[0] <= K_MAX)


def build() -> ctypes.CDLL:
    """Compile (at first use) and load the kernel library."""
    lib = _build.load_library("petal_ica_update", ("ica_update.cu",))
    fn = lib.petal_ica_update_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def _ica_update_plain(w, gx, gsum, p_inv: float, pad_g0: float):
    """The kernel's arithmetic in PyTorch: ``(W1, lim)``, step for step
    the host loop's ``_update`` with ``symmetric_decorrelation_ns``."""
    # Lazy: the models import this module.
    from ...models.fast_ica import symmetric_decorrelation_ns

    w_new = gx * p_inv - ((gsum - pad_g0) * p_inv)[:, None] * w
    w1 = symmetric_decorrelation_ns(w_new, NS_ITERS)
    lim = ((w1 * w.mT).sum(1).abs() - 1.0).abs().max()
    return w1, lim


def ica_update(w: torch.Tensor, gx: torch.Tensor, gsum: torch.Tensor,
               p_inv: float, pad_g0: float = 0.0):
    """``(W1, lim)`` of one FastICA step from ``w`` (k×k), ``gx`` = G·Xᵀ
    (k×k) and ``gsum``, the k g′ row sums; ``p_inv`` is 1/n, ``pad_g0``
    the g′ row-sum share of padded sample columns.  Both results stay on
    ``w``'s device.

    A CUDA ``w`` launches the kernel and raises where :func:`supports`
    does not hold or the launch is refused; a CPU ``w`` runs
    :func:`_ica_update_plain`."""
    global launches
    k = w.shape[0] if w.dim() == 2 else -1
    if w.dtype != torch.float32:
        raise TypeError(f"ica_update takes float32, got {w.dtype}")
    if (tuple(w.shape) != (k, k) or tuple(gx.shape) != (k, k)
            or tuple(gsum.shape) != (k,)):
        raise ValueError(
            f"ica_update takes a square W, G·Xᵀ of its shape and k sums; "
            f"got {tuple(w.shape)}, {tuple(gx.shape)}, {tuple(gsum.shape)}")
    if gx.dtype != w.dtype or gsum.dtype != w.dtype:
        raise TypeError("ica_update's operands must share W's dtype")
    if w.device.type == "cpu":
        return _ica_update_plain(w, gx, gsum, p_inv, pad_g0)
    if not supports(w):
        raise ValueError(
            f"a {k}x{k} W on {w.device} is outside K4's reach "
            f"(CUDA, 1 <= k <= {K_MAX})")
    if gx.device != w.device or gsum.device != w.device:
        raise ValueError("ica_update's operands must lie on W's device")
    w, gx, gsum = w.contiguous(), gx.contiguous(), gsum.contiguous()
    w1 = torch.empty_like(w)
    lim = torch.empty((), dtype=w.dtype, device=w.device)
    lib = build()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.petal_ica_update_f32(
            w.data_ptr(), gx.data_ptr(), gsum.data_ptr(), w1.data_ptr(),
            lim.data_ptr(), k, p_inv, pad_g0, NS_ITERS, stream)
    _build.check(lib, status, "petal_ica_update_f32 kernel launch")
    launches += 1
    debugging.check_kernel_outputs("ica_update (K4)", w1, lim)
    return w1, lim
