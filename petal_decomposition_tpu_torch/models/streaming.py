"""Out-of-core (streamed) fits — the counterpart of
``petal_decomposition_tpu/models/streaming.py``, whose function names it
keeps.

A stream is an iterable of 2-D row blocks (numpy arrays, CPU tensors or
anything ``np.asarray`` takes), or one 2-D array-like that is sliced on
the host without a copy (an ``np.memmap`` streams from disk).  The host
re-buffers the blocks into chunks of ``block_rows`` rows (65536 by
default; the tail chunk keeps its true size, since an eager program has
no one-shape constraint to pad for) and the device accumulates exactly
what every Gram-path fit consumes: the d×d Gram, the column sums and
‖X‖²_F.  Nothing larger than ``block_rows × d`` plus d×d lives on the
device, so n is unbounded.

The host→device pipeline (:func:`_device_prefetch`): a worker thread
runs every host cost — the user's generator, memmap page-ins, the
re-buffering — and copies each chunk into a ring of pinned staging
buffers, from which it issues the host→device copy on a CUDA copy
stream of its own and records an event; the compute stream waits on
that event before the chunk's accumulation.  A staging buffer is
refilled only after its last copy has completed, and a device block
only after the work that read it; the copy into a newly allocated block
waits for the compute stream's pending work, which may still read that
memory.  ``PETAL_STREAM_PREFETCH`` (default 2)
is the number of chunks staged ahead; 0 copies synchronously on the
caller's thread.  On the CPU the same worker hands over plain tensors.

What the feed spent is counted on every streamed fit, in
``last_fit_stats_.extra`` (:class:`_FeedCounters`): ``feed_wait_s``,
the caller's wait for the next chunk; ``host_copy_s``, the copies into
the staging buffers (at depth 0, the synchronous copies to the device);
``staged_bytes``.  Under a ``torch.profiler`` the same boundaries are
spans: ``petal.stream.feed_wait``, ``petal.stream.accum`` and
``petal.stream.solve`` on the caller's thread, ``petal.stream.host_copy``
and ``petal.stream.slot_wait`` on the worker's.

Numerical contract (single pass, shifted accumulation), as the JAX
package's:

* The Gram is accumulated about a provisional shift μ̂ (the first
  chunk's column mean), so the final re-centering subtracts ``n·δδᵀ``
  with δ = μ − μ̂ ≈ 0; the residual ratio r = n‖δ‖²/tr(Gc) is reported
  as ``last_fit_stats_.extra["mean_shift_ratio"]`` and guarded
  (:func:`_check_shift_ratio`).
* The Gram and moments are carried across chunks in the grade's
  :func:`..ops.gram.carry_dtype` (float64 but for the explicit
  ``"default"`` grade on float32 data on the card).  The factorization
  runs at the stream's dtype.
* σ come off the Gram (σ = √λ): float64 streams keep ~1e-9-grade σ,
  float32 ones are Gram-grade.  The streamed randomized fit rebuilds the
  in-core zero-pass recovery from the Gram's l×l algebra
  (``ops.gram_recovery.randomized_gram_recovery``), at the same Ω as the
  in-core fit of the same seed.
* Signs: with no thin U, each component's largest-|·| entry is made
  positive (``flip_components``), so streamed and in-core fits may
  differ by a sign per component.

FastICA streams in two passes: pass 1 accumulates the moments and gives
the whitening K; pass 2 writes ``X₁ = K·(X − μ)ᵀ·√n`` into a k×n buffer on
the device, and ``ica_par`` runs on it as in core.

On a mesh (the model's ``mesh``, :mod:`..parallel.mesh`):

* In one process, ``block_rows`` rounds up to a multiple of the mesh
  size, every chunk is split into row shards on the mesh's devices, and
  each chunk's Gram and moments are the sum of its shards' (in mesh
  order).  Streamed FastICA keeps the whitened buffer as column blocks,
  one a shard, its width padded only to the next multiple of the mesh
  size, and iterates on them as the in-core mesh fit does.
* Across processes (multi-host), every process feeds its own rows and
  accumulates them on its first device; a first collective agrees on
  the width, the dtype and one provisional shift (process 0's), and the
  finalize gathers every process's moments and sums them in process
  order, so each process solves the same operands to the same state.  A
  process with no rows, or with another width or dtype, makes every
  process raise.  ``partial_fit`` is then collective: every process
  calls it, also with no new rows.  Streamed FastICA takes one process.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
import warnings

import numpy as np
import torch

from ..errors import InvalidInput, LinalgError
from ..ops import gram as _gram
from ..ops import linalg as _linalg
from ..ops.gram_recovery import (
    flip_components as _flip_components,
    randomized_gram_recovery as _randomized_solve,
)
from ..ops.linalg import eigh_psd_jit_cert, mdot
from ..parallel.distributed import all_gather, psum
from ..parallel.mesh import Columns
from ..utils import rng as rng_util
from ..utils.profiling import span
from . import _common

__all__ = [
    "accumulate_moments",
    "exact_pca_from_gram",
    "randomized_pca_from_gram",
    "StreamMoments",
]

# 64k rows: a 4096-wide float32 chunk is 1 GiB, a 1024-wide one 256 MiB.
_DEFAULT_BLOCK_ROWS = 65536

# How often a thread waiting on the other side of the pipeline checks
# that it should still wait (seconds).
_POLL_S = 0.1


def _accum_step(carry, block, shift, *, mesh=None) -> None:
    """Fold one chunk into ``carry = (g, s, sq)`` in place: the shifted
    Gram and the first and second moments.  ``s`` and ``sq`` are float64;
    each chunk's moments are summed in ``g``'s dtype, the grade's carry
    (:func:`_init_stream_carry`), and widened.  With a (one-process)
    ``mesh`` the chunk is split into row shards on its devices and their
    moments summed in mesh order; without one it is a single shard."""
    g, s, sq = carry

    def moments(part, shift_d):
        xb = part - shift_d.to(part.dtype)
        return (_gram.gram(xb), xb.sum(0, dtype=g.dtype),
                (xb * xb).sum(dtype=g.dtype))

    devices = (block.device,) if mesh is None else mesh.devices
    each = [moments(p.to(dev), shift.to(dev)) for p, dev in
            zip(torch.tensor_split(block, len(devices)), devices)]
    gb, sb, sqb = (psum([e[i] for e in each], mesh) for i in range(3))
    g.add_(gb.to(g.dtype))
    s.add_(sb.to(s.dtype))
    sq.add_(sqb.to(sq.dtype))


def _finalize_centered(g, s, sq, shift, n: float):
    """Re-center the shifted accumulators: means, centered Gram, total
    variance, and the residual shift ratio r = n‖δ‖²/tr(Gc)."""
    g = g.to(torch.float64)
    delta = s / n
    means = shift + delta
    gc = g - n * torch.outer(delta, delta)
    dsq = n * (delta * delta).sum()
    tv = torch.clamp(sq - dsq, min=0)
    r = dsq / torch.clamp(torch.trace(gc), min=1e-300)
    return means, gc, tv, r


class StreamMoments:
    """Result of one accumulation pass over a stream."""

    def __init__(self, means, gram, total_variance, shift_ratio,
                 n_samples: int, n_blocks: int, dtype,
                 precision: str = "highest"):
        self.precision = precision
        self.means = means  # (d,) torch dtype of the stream
        self.gram = gram  # (d, d) float64, centered when requested
        self.total_variance = total_variance  # float64 scalar
        self.shift_ratio = shift_ratio  # float64 scalar
        self.n_samples = n_samples
        self.n_blocks = n_blocks
        self.dtype = dtype  # torch dtype of the stream


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _host_array(b) -> np.ndarray:
    """A block as a host numpy array (a tensor on the card is copied)."""
    if isinstance(b, torch.Tensor):
        return b.detach().cpu().numpy()
    return np.asarray(b)


def _coerce_block(b, dtype):
    """``(block, stream_dtype)``; ``b`` must be non-empty — zero-row
    blocks are skipped by the caller *before* coercion, so they can never
    pin the stream dtype."""
    if np.issubdtype(b.dtype, np.complexfloating):
        raise InvalidInput(
            "streamed fits support real dtypes only (complex fits are "
            "in-core)"
        )
    if dtype is None:
        # The first block decides the stream dtype (as_matrix rules:
        # integers and booleans promote to float64).
        dtype = (
            np.dtype(np.float64)
            if not np.issubdtype(b.dtype, np.floating)
            else b.dtype
        )
    elif b.dtype != dtype and not np.can_cast(b.dtype, dtype,
                                              casting="safe"):
        # A single pass cannot re-promote what it already consumed.
        raise InvalidInput(
            f"block dtype {b.dtype} does not safely cast to the stream "
            f"dtype {np.dtype(dtype)} (fixed by the first block); cast "
            "the stream to one dtype up front"
        )
    return b.astype(dtype, copy=False), dtype


def _check_block_rows(block_rows: int) -> None:
    if block_rows <= 0:
        raise InvalidInput("block_rows must be positive")


def _iter_input_blocks(data, step: int):
    """A 2-D array(-like) streams as row-slice views of ``step`` rows
    (no copy, which is what lets an ``np.memmap`` stream from disk);
    anything else is iterated as the user's blocks."""
    if getattr(data, "ndim", None) == 2:
        n = data.shape[0]
        for i in range(0, max(n, 1), step):
            yield data[i : i + step]
        return
    yield from data


def _uniform_chunks(blocks, block_rows: int, *, dtype_hint=None):
    """Re-buffer arbitrary-size input blocks into chunks of
    ``block_rows`` rows; the final chunk keeps its true size (no
    padding).  ``dtype_hint`` continues an existing stream's dtype
    (``partial_fit`` across calls) under the same safe-cast rule as
    within one stream."""
    _check_block_rows(block_rows)
    buf: list[np.ndarray] = []
    have = 0
    dtype = dtype_hint
    d = None
    for b in blocks:
        b = _host_array(b)
        if b.ndim != 2:
            raise InvalidInput(f"expected 2-dimensional blocks, got {b.ndim}-d")
        if b.shape[0] == 0:
            continue
        b, dtype = _coerce_block(b, dtype)
        if d is None:
            d = b.shape[1]
        elif b.shape[1] != d:
            raise InvalidInput(
                f"inconsistent block widths: expected {d}, got {b.shape[1]}"
            )
        buf.append(b)
        have += b.shape[0]
        while have >= block_rows:
            joined = buf[0] if len(buf) == 1 else np.concatenate(buf)
            yield joined[:block_rows]
            rest = joined[block_rows:]
            buf = [rest] if rest.shape[0] else []
            have = rest.shape[0]
    if have:
        yield buf[0] if len(buf) == 1 else np.concatenate(buf)


def _prefetch_depth() -> int:
    """Chunks staged ahead of the consumer (``PETAL_STREAM_PREFETCH``,
    default 2); 0 copies synchronously, with no worker thread."""
    raw = os.environ.get("PETAL_STREAM_PREFETCH", "2")
    try:
        depth = int(raw)
    except ValueError:
        depth = -1
    if depth < 0:
        raise InvalidInput(
            f"PETAL_STREAM_PREFETCH must be a non-negative integer, got "
            f"{raw!r}"
        )
    return depth


def _host_tensor(chunk: np.ndarray) -> torch.Tensor:
    """A chunk as a CPU tensor viewing it.  A read-only array (a read-only
    memmap) is wrapped too: the stream only reads its chunks, so torch's
    warning about wrapping a non-writable array does not apply."""
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", "The given NumPy array is not writable", UserWarning
        )
        return torch.from_numpy(np.ascontiguousarray(chunk))


class _FeedCounters:
    """What one streamed call's feed spent, over its chunks (both passes
    of a streamed FastICA), each timed where its span opens.  The caller's
    thread adds ``feed_wait_s``, the thread that stages a chunk
    ``host_copy_s`` and ``staged_bytes``."""

    def __init__(self):
        self.feed_wait_s = 0.0
        self.host_copy_s = 0.0
        self.staged_bytes = 0

    @contextlib.contextmanager
    def waiting(self):
        t0 = time.perf_counter()
        with span("petal.stream.feed_wait"):
            yield
        self.feed_wait_s += time.perf_counter() - t0

    @contextlib.contextmanager
    def copying(self, nbytes: int):
        t0 = time.perf_counter()
        with span("petal.stream.host_copy"):
            yield
        self.host_copy_s += time.perf_counter() - t0
        self.staged_bytes += nbytes

    def record(self, extra: dict) -> None:
        extra["feed_wait_s"] = self.feed_wait_s
        extra["host_copy_s"] = self.host_copy_s
        extra["staged_bytes"] = self.staged_bytes


class _Slot:
    """One pinned staging buffer, its device block, and the events of the
    last copy out of the one and of the last work that read the other."""

    def __init__(self):
        self.host = None
        self.dev = None
        self.copied = torch.cuda.Event()
        self.consumed = torch.cuda.Event()


class _PinnedRing:
    """The card's side of the pipeline: ``n_slots`` (pinned staging,
    device block) pairs and a copy stream.  :meth:`load` runs on the
    worker thread, :meth:`ready` and :meth:`release` on the consumer's,
    whose current stream is the compute stream."""

    def __init__(self, device: torch.device, n_slots: int,
                 stop: threading.Event, feed: _FeedCounters):
        self.device = device
        self.feed = feed
        self.compute = torch.cuda.current_stream(device)
        self.copy_stream = torch.cuda.Stream(device)
        self.stop = stop
        # Held while a copy is issued and while the ring closes, so no
        # copy starts after :meth:`close`.
        self.lock = threading.Lock()
        self.closed = False
        self.slots = [_Slot() for _ in range(n_slots)]
        self.free: queue.Queue = queue.Queue()
        for slot in self.slots:
            self.free.put(slot)

    def _free_slot(self):
        while not self.stop.is_set():
            try:
                return self.free.get(timeout=_POLL_S)
            except queue.Empty:
                continue
        return None

    def load(self, chunk: np.ndarray):
        """Stage ``chunk`` and start its copy to the card: ``(slot, rows)``,
        or None once the consumer has stopped."""
        with span("petal.stream.slot_wait"):
            slot = self._free_slot()
        if slot is None:
            return None
        n, d = chunk.shape
        dtype = _torch_dtype(chunk.dtype)
        host = slot.host
        if (host is None or host.shape[0] < n or host.shape[1] != d
                or host.dtype != dtype):
            # The first chunk, the stream's largest, sizes every slot (none
            # is in flight yet); a later larger one only its own.  A
            # dropped staging buffer is safe: the pinned allocator holds it
            # until its copies complete.  A new device block comes from the
            # compute stream's pool, which may hand over memory that compute
            # work already enqueued still reads (a freed temporary of the
            # same size); the copy stream writes it, so it waits for that
            # work first.
            for s in self.slots if host is None else (slot,):
                s.host = torch.empty((n, d), dtype=dtype, pin_memory=True)
                with torch.cuda.stream(self.compute):
                    s.dev = torch.empty((n, d), dtype=dtype,
                                        device=self.device)
            self.copy_stream.wait_stream(self.compute)
        else:
            # The last copy out of this staging buffer must be done
            # before the host writes it again.
            with span("petal.stream.slot_wait"):
                slot.copied.synchronize()
        stage = slot.host[:n]
        with self.feed.copying(chunk.nbytes):
            stage.copy_(_host_tensor(chunk))
        with self.lock:
            if self.closed or self.stop.is_set():
                return None
            with torch.cuda.stream(self.copy_stream):
                # The device block is rewritten only after the work that
                # read it last.
                self.copy_stream.wait_event(slot.consumed)
                slot.dev[:n].copy_(stage, non_blocking=True)
                slot.copied.record(self.copy_stream)
        return slot, n

    def ready(self, item) -> torch.Tensor:
        slot, n = item
        self.compute.wait_event(slot.copied)
        return slot.dev[:n]

    def release(self, item) -> None:
        slot, _ = item
        slot.consumed.record(self.compute)
        self.free.put(slot)

    def close(self) -> None:
        # No copy may still write a device block once the ring is freed,
        # including one the worker would issue after this.
        with self.lock:
            self.closed = True
            self.copy_stream.synchronize()


def _prefetch_worker(chunks, stage, offer) -> None:
    """The worker thread's loop: pull host chunks (every upstream host
    cost runs here), stage each, and hand it over with ``offer``; a
    failure is handed over in its place, to be raised in stream order."""
    try:
        for chunk in chunks:
            item = stage(chunk)
            if item is None or not offer(item):
                return
        offer(_DONE)
    except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
        offer(e)


_DONE = object()


def _device_prefetch(chunks, device: torch.device,
                     feed: _FeedCounters | None = None):
    """Yield each host chunk of ``chunks`` as a tensor on ``device``,
    with the host side pipelined behind the device's work, counting what
    the feed spent in ``feed``.

    A worker thread pulls the chunks and stages up to
    ``_prefetch_depth()`` of them ahead of the consumer (on the card:
    pinned staging, an asynchronous copy on a copy stream, an event the
    compute stream waits on; :class:`_PinnedRing`).  The consumer only
    enqueues device work, so production, transfer and accumulation
    overlap.  A yielded block is valid until the consumer asks for the
    next one.

    Error contract: an exception on the host side is re-raised here, in
    stream order (chunks before it are already consumed).  A consumer
    that stops early signals the worker to stop and drains it.  The
    consumer never waits on a dead worker: it polls, and raises if the
    worker has ended without handing over a result.
    """
    feed = _FeedCounters() if feed is None else feed
    depth = _prefetch_depth()
    if depth == 0:
        for chunk in chunks:
            with feed.copying(chunk.nbytes):
                block = _host_tensor(chunk).to(device)
            yield block
        return

    stop = threading.Event()
    on_card = device.type == "cuda"
    ring = _PinnedRing(device, depth + 1, stop, feed) if on_card else None
    # On the card the ring bounds the chunks in flight; on the CPU the
    # queue does.
    q: queue.Queue = queue.Queue(maxsize=0 if on_card else depth)

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def stage_on_card(chunk):
        with torch.cuda.device(device):
            return ring.load(chunk)

    def stage_on_host(chunk):
        with feed.copying(chunk.nbytes):
            return _host_tensor(chunk)

    t = threading.Thread(
        target=_prefetch_worker,
        args=(chunks, stage_on_card if on_card else stage_on_host, offer),
        name="petal-stream-prefetch", daemon=True,
    )
    t.start()
    try:
        while True:
            with feed.waiting():
                item = _next_item(q, t)
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            if ring is None:
                yield item
            else:
                yield ring.ready(item)
                ring.release(item)
    finally:
        stop.set()
        while True:  # unblock a worker waiting to hand over
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)
        if ring is not None:
            ring.close()


def _next_item(q: queue.Queue, worker: threading.Thread):
    """The worker's next hand-over: a chunk, an error or ``_DONE``.  Polls,
    so a worker that ended without handing one over raises here."""
    while True:
        try:
            return q.get(timeout=_POLL_S)
        except queue.Empty:
            if worker.is_alive():
                continue
            try:  # handed over just before the worker ended
                return q.get_nowait()
            except queue.Empty:
                raise RuntimeError(
                    "the stream's prefetch worker ended without "
                    "handing over a chunk or an error"
                ) from None


class _StreamState:
    """Accumulator over the chunks of a stream — one per ``fit_batched``,
    and kept on the model by ``partial_fit``.  On a mesh spanning
    processes the stream is multi-host: each process accumulates its own
    rows on its first device, and the finalize folds them
    (:func:`_fold_process_moments`); on a one-process mesh the chunks are
    row-sharded (``put_mesh``)."""

    def __init__(self, block_rows: int, device: torch.device, mesh=None):
        self.block_rows = block_rows
        self.mesh = mesh
        self.multihost = mesh is not None and mesh.spans_processes
        self.put_mesh = None if self.multihost else mesh
        self.device = device
        self.carry = None  # (g, s, sq) on the device
        self.shift = None  # (d,) float64 on the device
        self.n = 0
        self.n_blocks = 0
        self.calls = 0
        self.d = None
        self.dtype = None  # numpy dtype of the stream
        self.precision = None  # the resolved Gram grade (first chunk)


def _resolve_block_rows(block_rows: int | None, mesh=None) -> int:
    """``block_rows`` (default 65536), rounded up to a multiple of the
    size of a one-process mesh so every full chunk splits evenly."""
    if block_rows is None:
        block_rows = _DEFAULT_BLOCK_ROWS
    _check_block_rows(block_rows)
    if mesh is not None and not mesh.spans_processes:
        block_rows = -(-block_rows // mesh.size) * mesh.size
    return block_rows


def _multihost_prologue(st: _StreamState, chunks, centering: bool):
    """Multi-host stream setup: peek this process's first chunk, agree
    with every process on the width, the dtype and one provisional shift
    (process 0's first-chunk mean, so the fold can simply sum the
    moments), and hand the chunk back.  Collective: a process without a
    chunk, or a width or dtype that differs, makes every process raise
    (one that raised alone would leave the others waiting)."""
    import itertools

    it = iter(chunks)
    first = next(it, None)
    mine = ([1, first.shape[1], np.dtype(first.dtype).num]
            if first is not None else [0, -1, -1])
    info = all_gather(torch.tensor(mine, dtype=torch.int64), st.mesh)
    if not bool(info[:, 0].all()):
        raise InvalidInput(
            "multi-host streams require at least one block on every "
            "process (collective shift consensus); processes without: "
            f"{(info[:, 0] == 0).nonzero().ravel().tolist()}"
        )
    if not bool((info[:, 1:] == info[0, 1:]).all()):
        raise InvalidInput(
            "inconsistent block widths or dtypes across processes: "
            + ", ".join(f"proc {i}: d={int(w)}, dtype_code={int(c)}"
                        for i, (_, w, c) in enumerate(info.tolist()))
            + f" (this process: {np.dtype(first.dtype).name})"
        )
    cand = (first.mean(axis=0, dtype=np.float64) if centering
            else np.zeros((first.shape[1],), np.float64))
    shifts = all_gather(torch.from_numpy(cand), st.mesh)
    st.shift = shifts[0].to(st.device)
    return itertools.chain([first], it)


def _fold_process_moments(g, s, sq, n: int, n_blocks: int, mesh):
    """Sum every process's ``(g, s, sq, n, n_blocks)``: one gather each,
    summed in process order, so every process gets the same bits and the
    solve after it replicates exactly."""
    def ordered_sum(t):
        parts = all_gather(t, mesh)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    counts = all_gather(torch.tensor([n, n_blocks], dtype=torch.int64), mesh)
    return (ordered_sum(g), ordered_sum(s), ordered_sum(sq),
            int(counts[:, 0].sum()), int(counts[:, 1].sum()))


def _init_stream_carry(st: _StreamState, block, centering: bool,
                       precision: str) -> None:
    """First-chunk setup: the stream's width and dtype, the resolved Gram
    grade, the provisional shift (the first chunk's column mean, taken on
    the device) and the accumulators, the Gram in the grade's carry
    dtype."""
    st.d = block.shape[1]
    st.dtype = _numpy_dtype(block.dtype)
    st.precision = _gram.resolve(precision, block.dtype, st.device.type,
                                 stream=True)
    f64 = torch.float64
    dev = block.device
    if st.shift is None:  # a multi-host prologue sets it for every process
        st.shift = (
            block.sum(0, dtype=f64) / block.shape[0]
            if centering
            else torch.zeros((st.d,), dtype=f64, device=dev)
        )
    g_dtype = _gram.carry_dtype(st.precision, block.dtype, dev.type)
    st.carry = (
        torch.zeros((st.d, st.d), dtype=g_dtype, device=dev),
        torch.zeros((st.d,), dtype=f64, device=dev),
        torch.zeros((), dtype=f64, device=dev),
    )


def _accumulate_chunks(st: _StreamState, chunks, centering: bool,
                       precision: str, feed: _FeedCounters) -> None:
    """Fold host chunks into ``st`` through :func:`_device_prefetch`.
    The grade is the stream's, fixed at its first chunk and kept by every
    later ``partial_fit`` call."""
    with contextlib.closing(_device_prefetch(chunks, st.device,
                                             feed)) as blocks:
        for block in blocks:
            if st.carry is None:
                _init_stream_carry(st, block, centering, precision)
            elif block.shape[1] != st.d:
                raise InvalidInput(
                    f"inconsistent block widths: expected {st.d}, "
                    f"got {block.shape[1]}"
                )
            with span("petal.stream.accum"):
                _accum_step(st.carry, block, st.shift, mesh=st.put_mesh)
            st.n += block.shape[0]
            st.n_blocks += 1


def _check_shift_ratio(m: StreamMoments) -> None:
    """Mean-nonstationarity guard: a stream whose mean drifts can push
    r = n‖δ‖²/tr(Gc) past the grade's rating, where the re-centering
    cancels catastrophically.  A single pass cannot re-read the data, so
    it fails loudly before any model state changes."""
    rmax = _gram.guard_rmax(m.precision)
    r = float(m.shift_ratio)
    if r > rmax:
        raise LinalgError(
            f"streamed re-centering is mean-nonstationary beyond the "
            f"gram_precision={m.precision!r} rating (shift ratio "
            f"r={r:.3g} > {rmax:g}): sigma would fall below the "
            "documented grade. Shuffle the stream, raise "
            "gram_precision, or fit() in core"
        )


def _moments_from_state(st: _StreamState, centering: bool) -> StreamMoments:
    g, s, sq = st.carry
    n, n_blocks = st.n, st.n_blocks
    if st.multihost:
        g, s, sq, n, n_blocks = _fold_process_moments(g, s, sq, n, n_blocks,
                                                      st.mesh)
    dtype = _torch_dtype(st.dtype)
    if centering:
        means64, gc, tv, r = _finalize_centered(g, s, sq, st.shift,
                                                float(n))
        means = means64.to(dtype)
    else:
        means = torch.zeros((st.d,), dtype=dtype, device=g.device)
        # Copies, not the carry itself: partial_fit keeps adding to it
        # in place.
        gc, tv = g.to(torch.float64, copy=True), sq.clone()
        r = torch.zeros((), dtype=torch.float64, device=g.device)
    m = StreamMoments(means, gc, tv, r, n_samples=n, n_blocks=n_blocks,
                      dtype=dtype, precision=st.precision)
    _check_shift_ratio(m)
    return m


def accumulate_moments(blocks, *, centering: bool = True,
                       block_rows: int | None = None,
                       precision: str = "highest",
                       device=None, mesh=None) -> StreamMoments:
    """One streamed pass: the (centered) Gram and moments of the whole
    stream, on ``device`` (the card by default; a mesh's first device).

    ``blocks`` is an iterable of 2-D row blocks, or one 2-D array-like
    sliced on the host.  ``precision`` is the Gram grade (``"auto"`` |
    ``"default"`` | ``"high"`` | ``"highest"``), resolved against the
    stream's dtype at the first chunk.  With a one-process ``mesh`` every
    chunk is row-sharded over it; with a mesh spanning processes each
    process feeds its own blocks and the call is collective (module
    docstring).

    >>> import numpy as np
    >>> x = np.arange(8.0).reshape(4, 2)
    >>> m = accumulate_moments([x[:2], x[2:]], block_rows=2, device="cpu")
    >>> m.n_samples, m.n_blocks
    (4, 2)
    >>> m.means.tolist()  # column means
    [3.0, 4.0]
    >>> xc = x - x.mean(0)
    >>> bool(np.allclose(m.gram.numpy(), xc.T @ xc))
    True
    >>> float(m.total_variance) == float((xc ** 2).sum())
    True
    """
    return _accumulate_moments(blocks, centering, block_rows, precision,
                               device, mesh, _FeedCounters())


def _accumulate_moments(blocks, centering: bool, block_rows: int | None,
                        precision: str, device, mesh,
                        feed: _FeedCounters) -> StreamMoments:
    """:func:`accumulate_moments`, counting what the feed spent in
    ``feed``."""
    device = _common.model_device(mesh, device)
    _common.check_device(device)
    block_rows = _resolve_block_rows(block_rows, mesh)
    st = _StreamState(block_rows, device, mesh)
    chunks = _uniform_chunks(_iter_input_blocks(blocks, block_rows),
                             block_rows)
    if st.multihost:
        chunks = _multihost_prologue(st, chunks, centering)
    _accumulate_chunks(st, chunks, centering, precision, feed)
    if st.carry is None:
        raise InvalidInput("empty stream: no data blocks")
    return _moments_from_state(st, centering)


def _exact_solve(gc):
    lam, v, off = eigh_psd_jit_cert(gc)  # ascending
    sigma = torch.sqrt(torch.clamp(lam.flip(0), min=0))
    vt = _flip_components(v.flip(1).mT)
    return sigma, vt, off


def exact_pca_from_gram(m: StreamMoments):
    """Exact-PCA factors from accumulated moments: ``(sigma, vt, off)``
    descending, at the stream dtype (the covariance eigenproblem of
    ``pca_fit_gram`` without the data-dependent thin U).  A float64 Gram
    up to 512×512 on the card is solved by K3.

    >>> import numpy as np
    >>> x = np.random.default_rng(0).standard_normal((200, 4))
    >>> m = accumulate_moments([x], device="cpu")
    >>> sigma, vt, off = exact_pca_from_gram(m)
    >>> s_ref = np.linalg.svd(x - x.mean(0), compute_uv=False)
    >>> bool(np.max(np.abs(sigma.numpy() - s_ref) / s_ref) < 1e-9)
    True
    >>> tuple(vt.shape)
    (4, 4)
    """
    return _exact_solve(m.gram.to(m.dtype))


def randomized_pca_from_gram(m: StreamMoments, gen: torch.Generator, *,
                             n_components: int, n_oversamples: int,
                             n_power_iters: int):
    """Randomized factors from accumulated moments: Ω (d × l) drawn from
    ``gen`` as the in-core fit draws it, the Gram range finder's subspace
    iteration, and the in-core exact recovery rebuilt from the Gram's l×l
    algebra.  Returns ``(sigma, vt, off)`` with l components.

    >>> import numpy as np
    >>> x = np.random.default_rng(1).standard_normal((300, 6))
    >>> m = accumulate_moments([x], device="cpu")
    >>> sigma, vt, off = randomized_pca_from_gram(
    ...     m, rng_util.generator_from_seed(7), n_components=2,
    ...     n_oversamples=4, n_power_iters=4)
    >>> tuple(sigma.shape), tuple(vt.shape)  # l = 2 + 4 = d: full rank
    ((6,), (6, 6))
    >>> s_ref = np.linalg.svd(x - x.mean(0), compute_uv=False)
    >>> bool(abs(float(sigma[0]) - s_ref[0]) / s_ref[0] < 1e-9)
    True
    """
    d = m.gram.shape[0]
    l = min(n_components + n_oversamples, m.n_samples, d)
    omega = rng_util.normal(gen, (d, l), m.dtype, m.gram.device)
    return _randomized_solve(m.gram.to(m.dtype), omega,
                             n_power_iters=n_power_iters)


def _check_stream_solver(model) -> None:
    """A pinned ``solver="full"`` asked for the thin-SVD accuracy, which a
    single pass cannot give: refuse rather than downgrade."""
    if getattr(model, "_solver", None) == "full":
        raise InvalidInput(
            "streamed fits are Gram-grade (sigma through the covariance "
            "eigenproblem, kappa^2 sensitivity); solver='full' cannot be "
            "honored in one pass - use solver='gram' or 'auto', or fit() "
            "in core"
        )


def _stream_gram_precision(model) -> str:
    """The Gram grade of a model's stream: ``RandomizedPca``'s
    ``gram_precision`` (``"auto"`` resolves at the first chunk), and
    ``"highest"`` for a model without the knob (``Pca``), in
    ``fit_batched`` and ``partial_fit`` alike.  The JAX package returns
    ``"auto"`` there, so its ``partial_fit`` of a ``Pca`` streams at
    ``"high"`` on an accelerator while its ``fit_batched`` and its
    docstring say ``"highest"`` (``ROADMAP.md`` §3)."""
    return getattr(model, "_gram_precision", "highest")


def _stream_fit(model, blocks, block_rows, solve):
    _common.check_device(model._device)
    with _common.record(model, 0, 0, model._device) as stats:
        model._stream = None  # a full fit restarts any partial_fit stream
        feed = _FeedCounters()
        m = _accumulate_moments(
            blocks, model._centering, block_rows,
            _stream_gram_precision(model), model._device, model._mesh, feed,
        )
        with span("petal.stream.solve"):
            solve(model, m)
        _stream_stats(stats, m, feed)
    return model


def stream_fit_exact(model, blocks, *, block_rows: int | None = None):
    """Shared implementation of ``Pca.fit_batched``."""
    _check_stream_solver(model)
    return _stream_fit(model, blocks, block_rows, _solve_exact)


def stream_fit_randomized(model, blocks, *, block_rows: int | None = None):
    """Shared implementation of ``RandomizedPca.fit_batched``."""
    return _stream_fit(model, blocks, block_rows, _solve_randomized)


def _check_stream_dims(m: StreamMoments, k: int) -> None:
    """Every dimension must be at least n_components (pca.rs:199-204);
    for a stream, n is known only after the pass."""
    if m.gram.shape[0] < k or m.n_samples < k:
        raise InvalidInput(f"every dimension should be at least {k}")


def _solve_exact(model, m: StreamMoments) -> None:
    _check_stream_dims(m, model._n_components)
    sigma, vt, off = exact_pca_from_gram(m)
    # Certificate before mutation: a failed refit leaves the model as it
    # was.
    _linalg.check_certificate(off, sigma.dtype, m.gram.shape[0],
                              "eigendecomposition")
    k_full = min(m.n_samples, m.gram.shape[0])
    _install_state(model, m, sigma[:k_full], vt, model._n_components)


def _solve_randomized(model, m: StreamMoments) -> None:
    _check_stream_dims(m, model._n_components)
    # Successive (partial) fits draw from successive sub-streams, as
    # fit() does.
    sub = rng_util.split(model._gen)
    sigma, vt, off = randomized_pca_from_gram(
        m, sub, n_components=model._n_components,
        n_oversamples=model._n_oversamples,
        n_power_iters=model._n_power_iters,
    )
    _linalg.check_certificate(off, sigma.dtype, m.gram.shape[0],
                              "eigendecomposition")
    _install_state(model, m, sigma, vt, model._n_components)


def _install_state(model, m: StreamMoments, sigma, vt, k: int) -> None:
    model._components = vt[:k, :].contiguous()  # as Pca's
    model._means = m.means
    model._singular = sigma[:k]
    model._singular_full = sigma
    model._total_variance = m.total_variance.to(sigma.dtype)
    model._n_samples = m.n_samples


def _stream_stats(stats, m: StreamMoments | None, feed: _FeedCounters,
                  n: int = 0, d: int = 0, n_blocks: int = 0) -> None:
    """A streamed fit's dims and counters on its ``_common.record`` stats:
    from the moments pass ``m``, or ``n``, ``d`` and ``n_blocks`` where
    there is none."""
    if m is not None:
        n, d, n_blocks = m.n_samples, int(m.gram.shape[0]), m.n_blocks
    stats.n_samples, stats.n_features = n, d
    stats.extra["streamed_blocks"] = n_blocks
    if m is not None:
        stats.extra["mean_shift_ratio"] = float(m.shift_ratio)
    feed.record(stats.extra)


def transform_batched(model, blocks, *, block_rows: int | None = None):
    """Project a stream chunk by chunk with the fitted model; returns the
    stacked (n, k) result as a CPU tensor."""
    block_rows = _resolve_block_rows(block_rows)
    outs = [
        model.transform(chunk).cpu()
        for chunk in _uniform_chunks(_iter_input_blocks(blocks, block_rows),
                                     block_rows)
    ]
    if not outs:
        raise InvalidInput("empty stream: no data blocks")
    return torch.cat(outs, dim=0)


def partial_fit_step(model, x_block, *, block_rows: int | None,
                     solve) -> None:
    """Shared ``partial_fit``: accumulate more rows into the model's
    stream, then re-finalize and re-solve, so the model is fitted after
    every call (sklearn ``IncrementalPCA`` semantics).

    Retry-safe: the call's chunks are materialized and validated before
    anything accumulates, so a malformed block or a raising generator
    leaves the stream as it was.  Zero new rows on an existing stream
    changes nothing (no sub-stream of the generator is drawn) — except on
    a multi-host stream, where the call is collective: it joins the fold
    and the solve, drawing a sub-stream on every process alike.  If the
    solve fails, the rows stay in the stream and the model is unchanged;
    the next successful call includes them.  The call's blocks are its
    input, coerced before its ``_common.record`` starts, as ``fit`` coerces
    its matrix; a call with nothing to do records nothing."""
    _check_stream_solver(model)
    st = model._stream
    mesh = model._mesh
    if st is None:
        _common.check_device(model._device)
        st = _StreamState(_resolve_block_rows(block_rows, mesh),
                          model._device, mesh)
        model._stream = st
    elif (block_rows is not None
          and _resolve_block_rows(block_rows, mesh) != st.block_rows):
        raise InvalidInput(
            f"block_rows is fixed at {st.block_rows} by the first "
            "partial_fit call"
        )
    chunks = list(_uniform_chunks(
        _iter_input_blocks(x_block, st.block_rows), st.block_rows,
        dtype_hint=st.dtype,
    ))
    if not chunks and st.carry is not None and not st.multihost:
        return
    with _common.record(model, 0, 0, model._device) as stats:
        if st.multihost and st.carry is None:
            chunks = list(_multihost_prologue(st, chunks, model._centering))
        feed = _FeedCounters()
        _accumulate_chunks(st, chunks, model._centering,
                           _stream_gram_precision(model), feed)
        if st.carry is None:
            raise InvalidInput("empty stream: no data blocks")
        st.calls += 1
        m = _moments_from_state(st, model._centering)
        with span("petal.stream.solve"):
            solve(model, m)
        _stream_stats(stats, m, feed)
        stats.extra["partial_fit_calls"] = st.calls


# -- streamed FastICA (two passes) -------------------------------------


def _reiterable_factory(data, step: int):
    """A zero-arg factory over ``data``'s blocks, for a fit that reads
    them twice.  2-D array-likes re-slice, callables re-invoke, sequences
    re-iterate; a one-shot iterator cannot replay and is refused."""
    if getattr(data, "ndim", None) == 2:
        return lambda: _iter_input_blocks(data, step)
    if callable(data):
        return data
    try:
        one_shot = iter(data) is data
    except TypeError as e:
        raise InvalidInput(
            f"expected a 2-D array-like, a sequence of blocks, or a "
            f"callable returning the block stream; got {type(data).__name__}"
        ) from e
    if one_shot:
        raise InvalidInput(
            "streamed FastICA reads the data twice (moments pass, then "
            "the whitened-fill pass) but got a one-shot iterator; pass "
            "a 2-D array-like (e.g. np.memmap), a list of blocks, or a "
            "zero-arg callable returning a fresh iterator"
        )
    return lambda: iter(data)


def _hbm_bytes_limit(device: torch.device) -> int | None:
    """The device memory the whitened buffer may use:
    ``PETAL_STREAM_ICA_HBM_BYTES`` if set, else the card's total memory;
    no limit on the CPU."""
    env = os.environ.get("PETAL_STREAM_ICA_HBM_BYTES")
    if env:
        try:
            return int(env)
        except ValueError:
            raise InvalidInput(
                f"PETAL_STREAM_ICA_HBM_BYTES must be an integer, got {env!r}"
            ) from None
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return None


def _check_ica_buffer_budget(k: int, n: int, dtype: torch.dtype,
                             device: torch.device,
                             n_devices: int = 1) -> None:
    """The fit keeps X₁ (k×n) on the device plus ~3 k×n temporaries of
    the iteration (W·X₁, g(W·X₁), and the update's read of X₁ᵀ).  On a
    mesh the buffer is split by columns, so each device holds its share
    of ``n_devices``."""
    limit = _hbm_bytes_limit(device)
    if limit is None:
        return
    itemsize = torch.empty((), dtype=dtype).element_size()
    need = 4 * k * n * itemsize // n_devices
    if need > limit:
        per_dev = (f" per device (mesh of {n_devices})" if n_devices > 1
                   else "")
        raise InvalidInput(
            f"streamed FastICA keeps the whitened k x n matrix on "
            f"device: {k} x {n} {str(dtype)[6:]} needs "
            f"~{need / 2**30:.1f} GiB{per_dev} (4 k n itemsize) but the "
            f"device reports {limit / 2**30:.1f} GiB; reduce n_components "
            f"or the sample count, or shard over a larger mesh"
        )


def _fill_transposed(buf, block, offset: int):
    """``whiten=False`` fill: the raw transposed block."""
    buf[:, offset : offset + block.shape[0]] = block.mT


def _fill_pass(factory, block_rows: int, n: int, d: int, dtype, device,
               fill_chunk, feed: _FeedCounters) -> None:
    """Second streamed pass: feed every chunk through
    ``fill_chunk(device_block, column_offset)`` through the same pipeline
    as the first, checking that the stream replays as it did."""
    filled = 0
    chunks = _uniform_chunks(_iter_input_blocks(factory(), block_rows),
                             block_rows, dtype_hint=_numpy_dtype(dtype))
    with contextlib.closing(_device_prefetch(chunks, device, feed)) as blocks:
        for block in blocks:
            rows, width = block.shape
            if width != d:
                raise InvalidInput(
                    f"stream changed between passes: expected {d} "
                    f"columns, got {width}"
                )
            if filled + rows > n:
                raise InvalidInput(
                    "stream changed between passes: more rows on the "
                    f"second pass than the {n} accumulated on the first"
                )
            fill_chunk(block, filled)
            filled += rows
    if filled != n:
        raise InvalidInput(
            f"stream changed between passes: {filled} rows on the second "
            f"pass vs {n} on the first"
        )


def stream_fit_fast_ica(model, data, *, block_rows: int | None = None):
    """Shared implementation of ``FastIca.fit_batched`` (two passes; the
    module docstring has the scheme).  Matches the in-core
    ``whiten_solver="eigh"`` fit of the same seed: pass 1's float64
    shifted Gram is the in-core whitening Gram, W₀ comes from the same
    sub-stream of the generator, and ``ica_par`` runs on the same X₁ up to
    accumulation roundoff."""
    from . import fast_ica as fi

    mesh = model._mesh
    if mesh is not None and mesh.spans_processes:
        raise InvalidInput(
            "streamed FastICA supports one-process meshes only (the "
            "whitened k x n buffer lives on one process's devices; a "
            "multi-host column split would need per-process column feeds)"
        )
    if model._whiten and model._whiten_solver == "svd":
        raise InvalidInput(
            "streamed FastICA whitens from the accumulated Gram "
            "(eigh, kappa^2 sensitivity); whiten_solver='svd' cannot "
            "be honored in a stream - use 'eigh' or 'auto', or fit() "
            "in core"
        )
    _common.check_device(model._device)
    with _common.record(model, 0, 0, model._device) as stats:
        block_rows = _resolve_block_rows(block_rows, mesh)
        factory = _reiterable_factory(data, block_rows)
        feed = _FeedCounters()
        if model._whiten:
            _stream_fit_whitened(model, factory, block_rows, fi, stats, feed)
        else:
            _stream_fit_no_whiten(model, factory, block_rows, fi, stats,
                                  feed)
    return model


def _stream_fit_whitened(model, factory, block_rows: int, fi, stats,
                         feed: _FeedCounters) -> None:
    """The whitened streamed FastICA: the moments pass, the eigh
    whitening, the whitened pass and the iteration."""
    device, mesh = model._device, model._mesh
    m = _accumulate_moments(factory(), True, block_rows, "highest", device,
                            mesh, feed)
    n, d = m.n_samples, int(m.gram.shape[0])
    k = min(n, d)
    if model._n_components is not None:
        if model._n_components > k:
            raise InvalidInput(f"n_components should be at most {k}")
        k = model._n_components
    if k == 0:  # n_components=0: the in-core degenerate fit
        model._components = torch.zeros((0, d), dtype=m.dtype, device=device)
        model._means = m.means
        model._n_iter = 0
        _stream_stats(stats, m, feed)
        return

    kmat, _sigma, off = fi.whitening_from_gram(m.gram.to(m.dtype), k,
                                               max(n, d))
    _linalg.check_certificate(off, m.dtype, d, "eigendecomposition")
    sub = rng_util.split(model._gen)
    w_init = rng_util.normal(sub, (k, k), m.dtype, device)
    w, n_iter, buf_cols = _ica_fill_and_iterate(
        model, factory, block_rows, m, k, kmat, w_init, mesh, fi, feed)
    model._components = mdot(w, kmat)
    model._means = m.means
    model._n_iter = n_iter
    _stream_stats(stats, m, feed)
    stats.n_iter = n_iter
    stats.extra["whitened_buffer_cols"] = buf_cols


def _ica_fill_and_iterate(model, factory, block_rows: int, m, k: int,
                          kmat, w_init, mesh, fi, feed: _FeedCounters):
    """The whitened pass and the iteration.  The buffer K·(X − 1μᵀ)ᵀ·√n
    is one k × (n_pad / size) column block on each device: the model's
    one device, or each of a one-process mesh's (each holds its share).
    n_pad is n rounded up past the last full chunk to a multiple of the
    device count (at most size − 1 zero columns, which the iteration's
    ``n_valid`` masks; none on one device), and ``_ica_par_core`` runs on
    the blocks with its sums reduced over them, as the in-core mesh fit
    does.  Returns ``(w, n_iter, n_pad)``."""
    n, d = m.n_samples, int(m.gram.shape[0])
    devices = (model._device,) if mesh is None else mesh.devices
    size = len(devices)
    full = (n // block_rows) * block_rows
    tail = n - full
    n_pad = full + (-(-tail // size) * size if tail else 0)
    _check_ica_buffer_budget(k, n_pad, m.dtype, devices[0], size)
    width = n_pad // size
    bufs = [torch.zeros((k, width), dtype=m.dtype, device=dev)
            for dev in devices]
    scale = float(np.sqrt(n))

    def fill_chunk(block, offset):
        y = mdot(kmat, (block - m.means).mT) * scale
        end = offset + block.shape[0]
        for i, buf in enumerate(bufs):
            lo, hi = max(offset, i * width), min(end, (i + 1) * width)
            if lo < hi:
                buf[:, lo - i * width:hi - i * width] = (
                    y[:, lo - offset:hi - offset].to(buf.device))

    _fill_pass(factory, block_rows, n, d, m.dtype, devices[0], fill_chunk,
               feed)
    w, n_iter = _ica_iterate(model, Columns(bufs, mesh, n_pad), n, w_init,
                             fi)
    return w, n_iter, n_pad


def _ica_iterate(model, xs: Columns, n_valid: int, w_init, fi):
    """``_ica_par_core`` on the filled buffer's column blocks (the tensor
    itself without a mesh) at the model's settings, resolved for the
    buffer's device, with the decorrelation checked: ``(w, n_iter)``."""
    device_type = xs.parts[0].device.type
    w, _, n_iter = fi._ica_par_core(
        xs.value(), fi._rounded(model._tol, _common.real_dtype(xs.dtype)),
        int(model._max_iter), w_init, model._fun, n_valid=n_valid,
        decorrelation=fi.resolve_decorrelation(model._decorrelation,
                                               device_type),
        precision=fi.resolve_iteration_precision(
            model._iteration_precision, xs.dtype, device_type),
    )
    fi.check_decorrelation(w)
    return w, int(n_iter)


def _stream_fit_no_whiten(model, factory, block_rows: int, fi, stats,
                          feed: _FeedCounters) -> None:
    """``whiten=False``: the data is certified centered and whitened, so
    pass 1 only measures the stream's extent (on the host, no Gram) and
    pass 2 fills the d×n transposed buffer ``ica_par`` runs on."""
    if model._mesh is not None:
        raise InvalidInput(
            "whiten=False streamed fits are single-device (the "
            "square d x d unmixing leaves nothing to shard over "
            "sources); drop the mesh"
        )
    device = model._device
    _common.check_device(device)
    n = n_blocks = 0
    d = dtype = None
    for chunk in _uniform_chunks(_iter_input_blocks(factory(), block_rows),
                                 block_rows):
        if d is None:
            d, dtype = chunk.shape[1], chunk.dtype
        n += chunk.shape[0]
        n_blocks += 1
    if d is None:
        raise InvalidInput("empty stream: no data blocks")
    if n == 0 or d == 0:
        raise InvalidInput(
            "whiten=False requires non-empty data (the square d x d "
            "unmixing W is undefined for empty input)"
        )
    tdtype = _torch_dtype(dtype)
    _check_ica_buffer_budget(d, n, tdtype, device)
    buf = torch.empty((d, n), dtype=tdtype, device=device)

    def fill_chunk(block, offset):
        _fill_transposed(buf, block, offset)

    _fill_pass(factory, block_rows, n, d, tdtype, device, fill_chunk, feed)
    sub = rng_util.split(model._gen)
    w_init = rng_util.normal(sub, (d, d), tdtype, device)
    w, n_iter = _ica_iterate(model, Columns([buf], None, n), n, w_init, fi)
    model._components = w.contiguous()  # as Pca's
    model._means = torch.zeros((d,), dtype=tdtype, device=device)
    model._n_iter = n_iter
    _stream_stats(stats, None, feed, n, d, n_blocks)
    stats.n_iter = n_iter
