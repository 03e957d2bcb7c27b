"""Row meshes and row-sharded matrices — the counterpart of
``petal_decomposition_tpu/parallel/mesh.py``.

The one parallel axis of a decomposition is the sample axis: the n×d
data matrix is split into row shards, every sample-axis contraction
(means, the Gram XᵀX, the sketch X·Ω, the projection QᵀX, FastICA's
G·Xᵀ) is a local product on each shard followed by one sum over the
shards (``parallel.distributed.psum``), and the small d×d, l×l and k×k
factorizations run replicated on the reduced operands.

A :class:`Mesh` is 1-D.  It holds this process's devices, one per
shard, in order — a device may repeat, so several shards can share one
card (or the CPU) — and the ``torch.distributed`` process group when one
is initialized.  Its ``size`` counts the shards of every process; every
process holds the same number.  A matrix reaches the shards in one of two
forms: whole on every process (:func:`shard_rows`,
:func:`shard_rows_padded`, or the whole matrix passed to a mesh model's
``fit``), each process keeping its own shards' rows; or as the rows each
process already holds (:func:`rows_from_local`), when no process holds
the whole.  Shard ``r·L + i`` (rank r, local index
i, L local shards) holds rows ``[(r·L + i)·m, (r·L + i + 1)·m)`` of the
matrix padded to ``size·m`` rows.  A model fitted on a mesh keeps its
state on the mesh's first local device.

JAX's ``row_sharding`` and ``replicated_sharding`` return sharding specs;
a torch tensor carries none, so they have no counterpart here: a
replicated operand is an ordinary tensor on each process's first device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "Mesh",
    "Rows",
    "Columns",
    "make_mesh",
    "shard_rows",
    "shard_rows_padded",
    "rows_from_local",
    "ROWS",
]

ROWS = "rows"


def _group_world():
    """``(group, rank, world)`` of the initialized default process group,
    or ``(None, 0, 1)``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    return None, 0, 1


class Mesh:
    """A 1-D mesh of row shards: ``devices`` (this process's, one per
    shard, repeats allowed), the process group (``None`` outside one),
    ``axis_names`` and ``size`` (the shard count of every process)."""

    def __init__(self, devices, group, rank: int, world: int,
                 axis_name: str = ROWS):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.group = group
        self.rank = rank
        self.world = world
        self.axis_names = (axis_name,)
        self.local_size = len(self.devices)
        self.size = self.local_size * world

    @property
    def lead(self) -> torch.device:
        """The first local device: where replicated operands, the
        replicated solves and a fitted model's state live."""
        return self.devices[0]

    @property
    def spans_processes(self) -> bool:
        return self.world > 1

    @property
    def on_accelerator(self) -> bool:
        return any(d.type != "cpu" for d in self.devices)

    def _key(self):
        return (self.devices, self.group, self.rank, self.world,
                self.axis_names)

    def __eq__(self, other) -> bool:
        """Two meshes are one where they hold the same devices in the
        same process group: a matrix placed on one is fitted on the
        other."""
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        devs = ", ".join(str(d) for d in self.devices)
        return (f"Mesh(size={self.size}, rank={self.rank}/{self.world}, "
                f"devices=[{devs}])")


def _on_devices(devices, tensors) -> list:
    """``tensors`` on each of ``devices``: one tuple per device, each
    device's copies made once."""
    cache: dict = {}
    for dev in devices:
        if dev not in cache:
            cache[dev] = tuple(t.to(dev) for t in tensors)
    return [cache[dev] for dev in devices]


def _default_devices(n_local: int | None, rank: int, world: int) -> list:
    """Every card this process sees, or in a group of several processes
    this process's own share of them (``multihost.local_cards``); else
    the CPU, which counts as many devices as asked for (as the JAX
    package's virtual CPU devices do)."""
    if not torch.cuda.is_available():
        return [torch.device("cpu")] * (n_local or 1)
    if world == 1:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    from .multihost import local_cards

    return [torch.device("cuda", i) for i in local_cards(rank, world)]


def make_mesh(n_devices: int | None = None, *, axis_name: str = ROWS,
              devices=None) -> Mesh:
    """A 1-D mesh of ``n_devices`` shards across every process of the
    initialized group (default: every card a lone process sees, or each
    process's own cards in a group, else one CPU shard).  ``devices`` lists this process's devices, one per
    shard, and may repeat one.  In a group every process must hold the
    same number of shards (checked; the call is then collective).

    >>> from petal_decomposition_tpu_torch.parallel import make_mesh
    >>> mesh = make_mesh(1, devices=["cpu"])
    >>> mesh.axis_names, mesh.size
    (('rows',), 1)
    """
    group, rank, world = _group_world()
    n_local = None
    if n_devices is not None:
        if n_devices < 1 or n_devices % world:
            raise ValueError(
                f"n_devices={n_devices} is not a positive multiple of the "
                f"{world} processes"
            )
        n_local = n_devices // world
    devs = list(_default_devices(n_local, rank, world) if devices is None
                else devices)
    if n_local is not None:
        if len(devs) < n_local:
            raise ValueError(
                f"{n_local} shards per process asked for, but only "
                f"{len(devs)} devices are listed"
            )
        devs = devs[:n_local]
    mesh = Mesh(devs, group, rank, world, axis_name)
    if world > 1:
        from .distributed import all_gather

        counts = all_gather(
            torch.tensor([mesh.local_size], dtype=torch.int64), mesh
        )
        if not bool((counts == mesh.local_size).all()):
            raise ValueError(
                "every process of a mesh must hold the same number of "
                f"shards; got {counts.ravel().tolist()}"
            )
    return mesh


class Rows:
    """This process's row shards of one (possibly zero-padded) n×d
    matrix on a mesh.

    ``shards`` are tensors on the mesh's devices, in mesh order; every
    shard has ``rows_per_shard`` rows.  ``valid[i]`` counts the rows of
    shard i that are data (the rest are zero padding); ``n_valid`` is
    the whole matrix's count and ``n_rows`` its padded one.  ``mesh`` is
    ``None`` for one unsharded tensor, which is how the single-device
    fits run the same pipelines.  ``np.asarray(rows)`` and
    :meth:`full` gather the whole padded matrix.
    """

    def __init__(self, shards, mesh: Mesh | None, n_valid: int,
                 rows_per_shard: int):
        self.shards = list(shards)
        self.mesh = mesh
        self.rows_per_shard = rows_per_shard
        n_shards = 1 if mesh is None else mesh.size
        self.n_rows = rows_per_shard * n_shards
        self.n_valid = n_valid
        first = 0 if mesh is None else mesh.rank * mesh.local_size
        self.valid = [
            int(min(max(n_valid - (first + i) * rows_per_shard, 0),
                    rows_per_shard))
            for i in range(len(self.shards))
        ]

    @classmethod
    def single(cls, x: torch.Tensor, n_valid: int | None = None) -> "Rows":
        """One tensor as a one-shard matrix (no mesh, no collective)."""
        n = x.shape[0]
        return cls([x], None, n if n_valid is None else n_valid, n)

    @property
    def shape(self):
        return (self.n_rows,) + tuple(self.shards[0].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    def is_complex(self) -> bool:
        return self.shards[0].is_complex()

    @property
    def padded(self) -> bool:
        return self.n_valid != self.n_rows

    def on_devices(self, *tensors):
        """Each tensor on every shard's device: one tuple per shard (the
        same tensors where a shard's device is theirs)."""
        return _on_devices([s.device for s in self.shards], tensors)

    def map(self, fn, *replicated) -> "Rows":
        """``fn(shard, valid, *replicated_on_its_device)`` on every shard:
        the row shards of the result."""
        outs = [
            fn(s, v, *reps) for s, v, reps in
            zip(self.shards, self.valid, self.on_devices(*replicated))
        ]
        return Rows(outs, self.mesh, self.n_valid,
                    outs[0].shape[0] if outs else 0)

    def like(self, full: torch.Tensor) -> "Rows":
        """This matrix's shard layout over ``full``, the whole padded
        matrix (rows of this process's shards; views where a shard lives
        on ``full``'s device)."""
        m = self.rows_per_shard
        first = 0 if self.mesh is None else self.mesh.rank * self.mesh.local_size
        shards = [
            full[(first + i) * m:(first + i + 1) * m].to(s.device)
            for i, s in enumerate(self.shards)
        ]
        return Rows(shards, self.mesh, self.n_valid, m)

    def full(self) -> torch.Tensor:
        """The whole padded matrix on the first shard's device (gathered
        across processes)."""
        if self.mesh is None:
            return self.shards[0]
        lead = self.mesh.lead
        local = (self.shards[0] if len(self.shards) == 1 else
                 torch.cat([s.to(lead) for s in self.shards]))
        if not self.mesh.spans_processes:
            return local
        from .distributed import all_gather

        return all_gather(local, self.mesh).reshape(
            (self.n_rows,) + tuple(local.shape[1:]))

    def __array__(self, dtype=None, copy=None):
        a = self.full().detach().cpu().numpy()
        return a if dtype is None else a.astype(dtype)


class Columns:
    """Column blocks of one k × n matrix, one block per row shard of the
    data (FastICA's whitened Xᵀ): what ``_ica_par_core`` iterates on.
    :meth:`value` is the tensor itself when there is one block and no
    mesh."""

    def __init__(self, parts, mesh: Mesh | None, n_cols: int):
        self.parts = list(parts)
        self.mesh = mesh
        self.n_cols = n_cols  # padded, over every process's blocks

    @property
    def shape(self):
        return (self.parts[0].shape[0], self.n_cols)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    def value(self):
        return self.parts[0] if self.mesh is None else self

    def map(self, fn) -> "Columns":
        return Columns([fn(p) for p in self.parts], self.mesh, self.n_cols)

    def psum(self, fn, *replicated) -> torch.Tensor:
        """``parallel.distributed.psum`` of ``fn(block,
        *replicated_on_its_device)`` over the blocks."""
        from .distributed import psum

        # A block may be a tuple of tensors (the ds64 stage's hi/lo).
        devs = [(p[0] if isinstance(p, tuple) else p).device
                for p in self.parts]
        return psum([fn(p, *reps) for p, reps in
                     zip(self.parts, _on_devices(devs, replicated))],
                    self.mesh)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _place(x: torch.Tensor, mesh: Mesh, m: int, n_valid: int) -> Rows:
    """This process's shards of ``x`` (the whole matrix, ``n_valid`` data
    rows) at ``m`` rows a shard."""
    first = mesh.rank * mesh.local_size
    return Rows(_carve(x, mesh, m, first * m, n_valid), mesh, n_valid, m)


def _carve(x: torch.Tensor, mesh: Mesh, m: int, start: int,
           stop: int) -> list:
    """The local shards of ``m`` rows each, shard i holding the rows
    ``[start + i·m, start + (i + 1)·m)`` of ``x`` below ``stop``: one copy
    of each device's row range where ``x`` is elsewhere, views into it
    where it is there; a shard that runs past ``stop`` is a copy padded
    with zeros."""
    ranges = []  # each shard's data rows [a, b)
    for i in range(mesh.local_size):
        a = start + i * m
        ranges.append((a, max(a, min(a + m, stop))))
    copies = {}  # device → (first row, one copy of its shards' rows)
    for dev, (a, b) in zip(mesh.devices, ranges):
        if dev != x.device:
            lo, hi = copies.get(dev, (a, b))
            copies[dev] = (min(lo, a), max(hi, b))
    copies = {dev: (lo, x[lo:hi].to(dev).contiguous())
              for dev, (lo, hi) in copies.items()}
    shards = []
    for dev, (a, b) in zip(mesh.devices, ranges):
        if dev == x.device:
            rows = x[a:b]
        else:
            lo, src = copies[dev]
            rows = src[a - lo:b - lo]
        if rows.shape[0] < m:
            pad = torch.zeros((m - rows.shape[0],) + tuple(x.shape[1:]),
                              dtype=x.dtype, device=dev)
            rows = torch.cat([rows, pad])
        shards.append(rows)
    return shards


def shard_rows(x, mesh: Mesh) -> Rows:
    """Place ``x`` row-sharded on the mesh.  The row count must be a
    multiple of the mesh size; :func:`shard_rows_padded` pads otherwise.
    In a group spanning processes, ``x`` is the whole matrix on every
    process, and each process takes the rows of its own shards.

    >>> import numpy as np
    >>> from petal_decomposition_tpu_torch.parallel import make_mesh
    >>> xs = shard_rows(np.zeros((4, 3)), make_mesh(2, devices=["cpu"] * 2))
    >>> xs.shape, len(xs.shards), tuple(xs.shards[0].shape)
    ((4, 3), 2, (2, 3))
    """
    x = _as_tensor(x)
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(
            f"{n} rows do not split evenly over {mesh.size} shards; use "
            "shard_rows_padded"
        )
    return _place(x, mesh, n // mesh.size, n)


def shard_rows_padded(x, mesh: Mesh):
    """Row-shard ``x``, padding the sample axis with zero rows up to a
    multiple of the mesh size: ``(sharded, n_valid)``.  The fits mask
    the padded rows out of every reduction.

    >>> import numpy as np
    >>> from petal_decomposition_tpu_torch.parallel.mesh import (
    ...     make_mesh, shard_rows_padded)
    >>> xs, n_valid = shard_rows_padded(np.ones((5, 2)),
    ...                                 make_mesh(1, devices=["cpu"]))
    >>> xs.shape, n_valid  # mesh of 1: no padding needed
    ((5, 2), 5)
    >>> xs, n_valid = shard_rows_padded(np.ones((5, 2)),
    ...                                 make_mesh(4, devices=["cpu"] * 4))
    >>> xs.shape, n_valid, xs.valid
    ((8, 2), 5, [2, 2, 1, 0])
    """
    x = _as_tensor(x)
    n = x.shape[0]
    m = -(-n // mesh.size)
    return _place(x, mesh, m, n), n


# The dtypes a process may hold rows in, by a code every process agrees
# on (-1: another dtype, which the fits then refuse).
_DTYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128,
           torch.float16, torch.bfloat16)


def _dtype_code(dtype: torch.dtype) -> int:
    return _DTYPES.index(dtype) if dtype in _DTYPES else -1


def rows_from_local(local, mesh: Mesh) -> Rows:
    """The matrix whose rows the processes of ``mesh`` hold between them:
    ``local`` is this process's own contiguous rows (a 2-D tensor, best
    already on this process's card, or an array), and the matrix is every
    process's rows in process order.  No process holds or copies the
    whole: each one's shards are views into ``local`` where it lives on
    the shard's device, else one copy of their rows.

    Collective: one gather of every process's row count, width and dtype,
    so that a width or dtype that differs, or a layout the mesh cannot
    hold, raises ``InvalidInput`` on every process and leaves none
    waiting.  ``rows_per_shard`` is the largest share of a shard; each
    process's rows fill its shards in order, and only the trailing shards
    of the mesh may hold fewer (zero-padded, masked by ``valid``), so
    every process before the last that holds rows holds a full share.

    >>> import torch
    >>> from petal_decomposition_tpu_torch.parallel import make_mesh
    >>> xs = rows_from_local(torch.ones(5, 2), make_mesh(4, devices=["cpu"] * 4))
    >>> xs.shape, xs.n_valid, xs.valid
    ((8, 2), 5, [2, 2, 1, 0])
    """
    from ..errors import InvalidInput
    from ..utils.profiling import span

    with span("petal.mesh.place"):
        x = _as_tensor(local)
        flat = x.dim() != 2
        mine = [-1 if flat else x.shape[0], -1 if flat else x.shape[1],
                _dtype_code(x.dtype)]
        if mesh.group is not None:  # a group of one gathers too
            from .distributed import all_gather

            info = all_gather(torch.tensor(mine, dtype=torch.int64),
                              mesh).tolist()
        else:
            info = [mine]
        counts = [c for c, _, _ in info]
        if min(counts) < 0:
            raise InvalidInput(
                "rows_from_local takes a 2-D matrix on every process; "
                f"processes without: {[i for i, c in enumerate(counts) if c < 0]}"
            )
        if len({(w, t) for _, w, t in info}) > 1:
            raise InvalidInput(
                "inconsistent widths or dtypes across processes: "
                + ", ".join(f"proc {i}: d={w}, dtype_code={t}"
                            for i, (_, w, t) in enumerate(info))
                + f" (this process: {x.dtype})"
            )
        m = -(-max(counts) // mesh.local_size)
        share = m * mesh.local_size
        short = [i for i, c in enumerate(counts) if c < share]
        if short and any(counts[i] for i in range(short[0] + 1, len(counts))):
            raise InvalidInput(
                "only the trailing processes may hold fewer rows than a "
                f"full share of {share}; row counts by process: {counts}"
            )
        if m == 0:
            raise InvalidInput("no process holds a row")
        shards = _carve(x, mesh, m, 0, x.shape[0])
        return Rows(shards, mesh, sum(counts), m)
