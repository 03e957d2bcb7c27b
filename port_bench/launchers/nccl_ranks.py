"""One process a card, all in one process group (NCCL on the cards, gloo
on the CPU): rank 0 makes the whole run of the cell
(:func:`port_bench.core.harness.run_cell`, unchanged) and ``chips − 1``
followers, one card each, build the same inputs and model and fit each
fit rank 0 announces, until it stops them (the placement's protocol,
``placements/local_rows.py``).  Rank 0's earlier lines name the
followers' process ids and, at the end, the fits each rank ran.

Before it starts a process it checks that the program places rows a
process already holds (``parallel.rows_from_local``); without it the run
exits at once with :data:`EXIT_NO_LOCAL_ROWS`.  A follower that dies
makes rank 0 end every process and exit with :data:`EXIT_RANK_LOST`, with
no result, within a second; a follower whose rank 0 has died leaves as
soon; rank 0 waits at most :data:`JOIN_S` for the followers to report
and leave.  Followers write to standard error only.

    python3 port_bench/launchers/nccl_ranks.py --follower RANK PORT ROOT CELL SEED

is a follower, started by :func:`launch`.
"""

from __future__ import annotations

import importlib
import os
import socket
import subprocess
import sys
import threading
import time

EXIT_NO_LOCAL_ROWS = 6
EXIT_RANK_LOST = 7
JOIN_S = 60
POLL_S = 0.2


def has_local_rows() -> bool:
    from petal_decomposition_tpu_torch import parallel

    return hasattr(parallel, "rows_from_local")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _device(torch):
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class _Watch(threading.Thread):
    """Rank 0's watch over its followers: one that ends before it is
    stopped ends the run."""

    def __init__(self, followers):
        super().__init__(daemon=True)
        self.followers = followers
        self.stopped = threading.Event()

    def run(self):
        while not self.stopped.is_set():
            for r, p in enumerate(self.followers, start=1):
                if p.poll() is not None and not self.stopped.is_set():
                    print(f"rank {r} ended with {p.returncode} during the "
                          "run; every rank is stopped", file=sys.stderr,
                          flush=True)
                    _kill(self.followers)
                    os._exit(EXIT_RANK_LOST)
            time.sleep(POLL_S)


def _kill(followers) -> None:
    for p in followers:
        if p.poll() is None:
            p.kill()
    for p in followers:
        p.wait()


def launch(root, cell, args, t_start) -> dict:
    if not has_local_rows():
        print("the program cannot place rows a process already holds "
              "(parallel.rows_from_local); this cell needs it",
              file=sys.stderr, flush=True)
        raise SystemExit(EXIT_NO_LOCAL_ROWS)
    import torch

    from petal_decomposition_tpu_torch.parallel import multihost
    from port_bench.core import harness, spec

    placement = spec.module(root, "placements", cell.traffic["inputs"])
    port = _free_port()
    followers = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--follower", str(r),
             str(port), str(root), cell.name, str(args.seed)],
            stdin=subprocess.DEVNULL, stdout=2)
        for r in range(1, cell.chips)
    ]
    harness.log({"followers": [p.pid for p in followers]})
    watch = _Watch(followers)
    watch.start()
    try:
        multihost.initialize(f"localhost:{port}", cell.chips, 0)
        result = harness.run_cell(root, cell, args.seed, args.seconds,
                                  bool(args.trace), _device(torch), t_start)
        fits = [placement.sent()]
        watch.stopped.set()
        placement.send(placement.STOP)
        deadline = time.monotonic() + JOIN_S
        for r in range(1, cell.chips):
            fits.append(placement.fits_of(
                r, max(deadline - time.monotonic(), 0.1)))
        harness.log({"fits_by_rank": fits})
        for r, p in enumerate(followers, start=1):
            code = p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            if code != 0:
                raise RuntimeError(f"rank {r} ended with {code}")
    finally:
        watch.stopped.set()
        _kill(followers)
    # No destroy_process_group: under NCCL it waits for every rank to
    # destroy its own, and the followers have left.
    return result


def _leave_with_rank0(parent: int) -> None:
    """A follower's watch: rank 0 (its parent) gone, it leaves."""
    while os.getppid() == parent:
        time.sleep(POLL_S)
    os._exit(EXIT_RANK_LOST)


def follow(rank: int, port: int, root: str, name: str, seed: int) -> None:
    sys.stdout = sys.stderr
    threading.Thread(target=_leave_with_rank0, args=(os.getppid(),),
                     daemon=True).start()
    sys.path.insert(0, root)
    import torch

    from petal_decomposition_tpu_torch.parallel import multihost
    from port_bench.core import harness, imports, spec

    cell = spec.cell(root, spec.load(root), name)
    cfg, traffic = cell.config, cell.traffic
    multihost.initialize(f"localhost:{port}", cell.chips, rank)
    device = _device(torch)
    family = importlib.import_module(f"port_bench.families.{cfg['family']}")
    placement = spec.module(root, "placements", traffic["inputs"])
    inputs = harness.make_inputs(root, torch, cfg, traffic, family, seed,
                                 device)
    entry = getattr(family.build_model(cfg, seed, device), traffic["entry"])
    while (c := inputs.follow()) is not None:
        entry(inputs.apply(c))
    loaded = imports.forbidden_loaded()
    if loaded:
        print(f"forbidden modules loaded by rank {rank}: {loaded}",
              file=sys.stderr, flush=True)
    placement.report_fits(rank, inputs.applied)
    # Leave at once, the group as it is: under NCCL, destroying it waits
    # for rank 0 to destroy its own, and rank 0 waits for this process.
    os._exit(4 if loaded else 0)


if __name__ == "__main__" and sys.argv[1:2] == ["--follower"]:
    _, _, r, p, root_dir, cell_name, s = sys.argv
    follow(int(r), int(p), root_dir, cell_name, int(s))
