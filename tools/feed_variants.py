#!/usr/bin/env python3
"""Time the ways a stream's pageable host blocks can reach the card.

    python3 tools/feed_variants.py

On the north-star stream of ``chip_smoke.py`` (16 host blocks of
65536 × 4096 float32, ``chip_smoke.north_star_blocks``), in GB/s:

* ``pipeline_writable`` / ``pipeline_read_only``: the stream's pipeline
  alone (``_device_prefetch`` at depth 2, nothing computed; the second
  of two passes) on the blocks and on read-only views of them, which
  take the same ``torch`` staging copy;
* ``host_to_pinned_torch`` / ``host_to_pinned_numpy``: the host copy of
  the blocks into a pinned buffer by ``torch`` ``copy_`` (PyTorch's CPU
  threads) and by ``np.copyto`` (one thread);
* ``pageable_h2d``: the blocks copied to the card directly;
* ``host_register``: ``cudaHostRegister`` of one block in place, the
  registered block's copy to the card (CUDA events, median of 5) and
  the unregistration.

Prints one JSON object with the card's name and power limit.  Needs a
CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import chip_smoke as cs  # noqa: E402


def host_register_rates(block, devb) -> dict:
    """``cudaHostRegister`` of one pageable block in place: the
    registration's GB/s (host clock), the registered block's copy to the
    card and the unregistration's; the CUDA error code where a call
    fails."""
    import torch

    cudart = torch.cuda.cudart()
    ptr, nbytes = block.ctypes.data, block.nbytes
    t0 = time.perf_counter()
    err = int(cudart.cudaHostRegister(ptr, nbytes, 0))
    out = {"register_gb_s": nbytes / (time.perf_counter() - t0) / 1e9}
    if err:
        return {"register_error": err}
    try:
        src = torch.from_numpy(block)
        out["registered_h2d_gb_s"] = nbytes / cs.cuda_ms(
            lambda: devb.copy_(src, non_blocking=True), 5) / 1e6
    finally:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        err = int(cudart.cudaHostUnregister(ptr))
        out["unregister_gb_s"] = nbytes / (time.perf_counter() - t0) / 1e9
    if err:
        out["unregister_error"] = err
    return out


def main() -> int:
    import numpy as np
    import torch

    from petal_decomposition_tpu_torch.models import streaming as pst

    if not torch.cuda.is_available():
        print("feed_variants: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    blocks = cs.north_star_blocks(dev)[0]
    torch.cuda.empty_cache()
    nbytes = blocks[0].nbytes
    total = cs.NS_BLOCKS * nbytes
    read_only = []
    for b in blocks:
        v = b.view()
        v.flags.writeable = False
        read_only.append(v)

    def pipeline(src):
        def run():
            with cs.prefetch_depth(2):
                for _ in pst._device_prefetch(iter(src), dev):
                    pass
        run()
        return cs.host_gbps(total, run)

    out = {"torch_threads": torch.get_num_threads(),
           "pipeline_writable": pipeline(blocks),
           "pipeline_read_only": pipeline(read_only)}
    pinned = torch.empty(blocks[0].shape, pin_memory=True)
    devb = torch.empty(blocks[0].shape, device=dev)

    def staged_torch():
        for b in blocks:
            pinned.copy_(torch.from_numpy(b))

    def staged_numpy():
        for b in blocks[:4]:
            np.copyto(pinned.numpy(), b)

    def pageable_h2d():
        for b in blocks:
            devb.copy_(torch.from_numpy(b))

    out["host_to_pinned_torch"] = cs.host_gbps(total, staged_torch)
    out["host_to_pinned_numpy"] = cs.host_gbps(4 * nbytes, staged_numpy)
    out["pageable_h2d"] = cs.host_gbps(total, pageable_h2d)
    out["host_register"] = host_register_rates(blocks[1], devb)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
