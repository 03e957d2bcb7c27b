"""Multi-process initialization — the counterpart of
``petal_decomposition_tpu/parallel/multihost.py``, over
``torch.distributed``.

Each process runs the same program, calls :func:`initialize` once
before it builds a mesh, and :func:`..mesh.make_mesh` then spans every
process of the group.  In core, a fit takes either form: every process
passes the whole matrix to ``fit`` and keeps the rows of its own shards,
or every process places only the rows it holds
(:func:`..mesh.rows_from_local`) and passes the resulting row shards, so
that no process holds or copies the whole; a stream feeds each process's
own rows.  Replicated state ends up bitwise equal on every
process: the reductions hand each one the same operands, and the small
solves are deterministic.

The backend is NCCL when the process has a card and gloo on the CPU.
``backend=`` exists so that several processes can share one card, which
NCCL refuses: they take gloo, whose collectives on card tensors go
through host memory.

The restart story is the serialization contract, as in the JAX package:
a fit is one-shot, so recovery is loading the last saved model
(``save``/``load``) and fitting again.
"""

from __future__ import annotations

import datetime
import os

import torch

__all__ = ["initialize", "is_multihost", "process_index", "process_count",
           "local_cards"]

# How long a process waits for the others to join the group.
_JOIN_TIMEOUT = datetime.timedelta(minutes=10)


def _default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def local_cards(rank: int, world: int) -> list[int]:
    """The card indices that process ``rank`` of ``world`` owns on its
    node: its share of the cards it sees, by its local rank.  torchrun's
    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` name the process's place on
    its node; without them every process of the group counts as local.
    One process per card is the usual layout (``torchrun
    --nproc_per_node`` = the card count); a process with more cards than
    its peers' share gets several, and processes that outnumber the
    cards share them round-robin.
    """
    n = max(torch.cuda.device_count(), 1)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    per = max(n // local_world, 1)
    return [(local_rank * per + j) % n for j in range(per)]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               backend: str | None = None) -> None:
    """Join (or form) the process group: an idempotent wrapper over
    ``torch.distributed.init_process_group``.

    The JAX package's error contract:

    * an already initialized group → no-op;
    * no arguments (auto mode) → torchrun's environment (``RANK``,
      ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) when it is set,
      else a no-op: one process is a valid configuration;
    * any failure with explicit arguments → raised: the caller asked for
      a group and did not get one.

    ``coordinator_address`` is ``host:port`` (or a full ``tcp://`` URL)
    where process 0 listens.  ``backend`` defaults to NCCL with a card
    and gloo without.  Under NCCL the process's current card becomes the
    first of its own (:func:`local_cards`), where its default mesh
    starts too, so no two ranks of a node open NCCL on one card.

    >>> from petal_decomposition_tpu_torch.parallel import multihost
    >>> multihost.initialize()  # auto mode, no group: a no-op
    >>> multihost.is_multihost()
    False
    >>> multihost.process_index()
    0
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return
    backend = backend or _default_backend()
    explicit = any(a is not None for a in
                   (coordinator_address, num_processes, process_id))
    if not explicit:
        env = os.environ
        if all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
            _select_card(backend, int(env["RANK"]), int(env["WORLD_SIZE"]))
            dist.init_process_group(backend, init_method="env://",
                                    timeout=_JOIN_TIMEOUT)
        return
    if coordinator_address is None or num_processes is None or (
            process_id is None):
        raise ValueError(
            "explicit initialization needs coordinator_address, "
            "num_processes and process_id"
        )
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"process_id {process_id} is outside [0, {num_processes})"
        )
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    _select_card(backend, process_id, num_processes)
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id,
                            timeout=_JOIN_TIMEOUT)


def _select_card(backend: str, rank: int, world: int) -> None:
    if backend == "nccl":
        torch.cuda.set_device(local_cards(rank, world)[0])


def is_multihost() -> bool:
    """True when this process is part of a group of more than one
    (example under :func:`initialize`)."""
    return process_count() > 1


def process_index() -> int:
    """This process's rank, 0 outside a group (example under
    :func:`initialize`)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes in the group, 1 outside one."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1
