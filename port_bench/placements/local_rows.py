"""Each process's own rows on its own card, and no process holding the
whole: ``fit(rows)`` of a matrix sharded because no card can hold it.

In a process group (``launchers/nccl_ranks.py``) every process runs the
family's generator over every block, as a whole-matrix generation would,
and keeps the rows of its own contiguous share (⌈n / processes⌉ rows, in
process order) on its card; ``parallel.rows_from_local`` places them on
the mesh of every process's cards.  At set-up each process sums its
share's rows piece by piece (each generated block cut at the shares'
bounds) in float64, values and squares, and rank 0 compares every
process's sums with those of the same pieces as it generated them: the
count of processes that differ is ``shard_mismatch``, which the family
reports as the ``shards`` check.

Rank 0 announces each fit's number through the group's store before its
timer starts (:func:`send`); every process rescales its own part of that
fit's rescaled block and then waits for the others, so that no fit's
time holds another process's rescale.  The followers read the numbers
(:meth:`LocalRows.follow`) until the launcher sends :data:`STOP`.
``row_blocks(c)`` regenerates the whole matrix from the seed on rank 0,
with fit ``c``'s rescale, for the reference.

Outside a process group (``control.py``) it holds no rows and only
regenerates.
"""

from __future__ import annotations

import datetime

from port_bench.core.inputs import Inputs, vary_of

STOP = "stop"
SEQ = "port_bench/fit_seq"
_TIMEOUT = datetime.timedelta(minutes=10)


def _store():
    import torch.distributed as dist

    return dist.distributed_c10d._get_default_store()


def send(message) -> None:
    """Rank 0: the next message to the followers, a fit's number or
    :data:`STOP`."""
    store = _store()
    store.set(f"{SEQ}/{store.add(SEQ, 1)}", str(message))


def sent() -> int:
    """How many messages rank 0 has sent."""
    return _store().add(SEQ, 0)


def report_fits(rank: int, fits: int) -> None:
    _store().set(f"port_bench/fits/{rank}", str(fits))


def fits_of(rank: int, timeout_s: float) -> int:
    """The fits process ``rank`` ran, once it has reported them (waits at
    most ``timeout_s``, then raises)."""
    store, key = _store(), f"port_bench/fits/{rank}"
    store.wait([key], datetime.timedelta(seconds=timeout_s))
    return int(store.get(key))


def _pieces(n: int, rows: int, share: int) -> list:
    """The generated blocks of ``rows`` rows cut at the shares' bounds:
    ``[(start, stop), ...]`` in row order."""
    cuts = sorted(set(range(0, n, rows)) | set(range(0, n, share)) | {n})
    return list(zip(cuts[:-1], cuts[1:]))


def _sums(torch, t):
    """float64 sum of ``t`` and of its squares."""
    return torch.stack([t.sum(dtype=torch.float64),
                        t.double().square().sum()])


class LocalRows(Inputs):
    def __init__(self, torch, cfg, family, seed, vary, device, rows=None,
                 span=(0, 0), group=None, shard_mismatch=0):
        self._torch, self._cfg, self._family = torch, cfg, family
        self._seed, self._device = seed, device
        self.n, self.d = int(cfg["data"]["n"]), int(cfg["data"]["d"])
        self.itemsize = getattr(torch, cfg["data"]["dtype"]).itemsize
        self.vary = vary
        self.arg = rows
        self._lo, self._hi = span
        self._group = group
        self._held = 1.0  # the factor this process's rows hold now
        self.applied = 0  # fits made ready on this process
        self.shard_mismatch = shard_mismatch

    def prepare(self, c: int):
        """Rank 0: announce fit ``c``, then make it ready."""
        if self._group is None:
            raise RuntimeError("local rows are held only in a process group")
        send(c)
        return self.apply(c)

    def follow(self):
        """A follower: the next fit's number, or None once rank 0 stops."""
        msg = _store().get(f"{SEQ}/{self.applied + 1}").decode()
        return None if msg == STOP else int(msg)

    def apply(self, c: int):
        """This process's part of fit ``c``'s rescale, then a wait for
        every process: the fit starts with all of them ready."""
        import torch.distributed as dist

        f = self.vary.factor(c)
        part = self.vary.overlap(self._lo, self._hi)
        if part is not None and f != self._held:
            local = self.arg.shards  # this process's shards, in row order
            m = self.arg.rows_per_shard
            for i, s in enumerate(local):
                a, b = max(part[0], i * m), min(part[1], (i + 1) * m)
                if a < b:
                    s[a - i * m:b - i * m] *= f / self._held
        self._held = f
        if self._device.type == "cuda":
            self._torch.cuda.synchronize(self._device)
        dist.barrier(group=self._group)
        self.applied += 1
        return self.arg

    def row_blocks(self, c: int):
        f = self.vary.factor(c)
        start = 0
        for blk in self._family.row_blocks(self._cfg, self._seed,
                                           self._device):
            part = self.vary.overlap(start, start + blk.shape[0])
            if part is not None:
                blk[part[0]:part[1]] *= f
            start += blk.shape[0]
            yield blk


def make(torch, cfg, traffic, family, seed, device) -> LocalRows:
    import torch.distributed as dist

    n, d = int(cfg["data"]["n"]), int(cfg["data"]["d"])
    vary = vary_of(traffic, n, seed)
    if not (dist.is_available() and dist.is_initialized()):
        return LocalRows(torch, cfg, family, seed, vary, device)
    from petal_decomposition_tpu_torch.parallel import (
        make_mesh,
        rows_from_local,
    )

    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = make_mesh()
    group = dist.new_group(backend="gloo", timeout=_TIMEOUT)
    share = -(-n // world)
    lo, hi = min(rank * share, n), min((rank + 1) * share, n)
    local = torch.empty((hi - lo, d), dtype=getattr(torch, cfg["data"]["dtype"]),
                        device=device)
    pieces = _pieces(n, int(cfg["data"].get("gen_rows", n)), share)
    generated = torch.zeros((len(pieces), 2), dtype=torch.float64)
    start, p = 0, 0
    for blk in family.row_blocks(cfg, seed, device):
        stop = start + blk.shape[0]
        a, b = max(start, lo), min(stop, hi)
        if a < b:
            local[a - lo:b - lo] = blk[a - start:b - start]
        while rank == 0 and p < len(pieces) and pieces[p][1] <= stop:
            pa, pb = pieces[p]
            generated[p] = _sums(torch, blk[pa - start:pb - start]).cpu()
            p += 1
        start = stop
    held = torch.zeros((len(pieces), 2), dtype=torch.float64)
    mine = [i for i, (pa, pb) in enumerate(pieces) if lo <= pa and pb <= hi]
    for i in mine:
        pa, pb = pieces[i]
        held[i] = _sums(torch, local[pa - lo:pb - lo]).cpu()
    everyone = [torch.zeros_like(held) for _ in range(world)]
    dist.all_gather(everyone, held, group=group)
    mismatch = 0
    if rank == 0:
        for r, sums in enumerate(everyone):
            r_lo, r_hi = min(r * share, n), min((r + 1) * share, n)
            own = [i for i, (pa, pb) in enumerate(pieces)
                   if r_lo <= pa and pb <= r_hi]
            if not torch.equal(sums[own], generated[own]):
                mismatch += 1
    rows = rows_from_local(local, mesh)
    del local
    return LocalRows(torch, cfg, family, seed, vary, device, rows, (lo, hi),
                     group, mismatch)
