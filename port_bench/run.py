#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the cards the cell asks
for.  Makes the cell's data on the card from ``--seed``, warms its
shapes, fits back to back for ``--seconds``, then compares what the
window's fits returned with the plain reference.  Earlier lines of
standard output carry the card's readings, each fit's time and
iterations and, with ``--trace 1``, where the profiler trace went; the
last line is the result object.  The last lines of standard error hold
each number compared, beside its limit.  Exits non-zero, with no result,
without the cards, without the program beside it, or where JAX or the
JAX package was loaded.
"""

import sys
import time

T_START = time.perf_counter()

from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from port_bench.core import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(sys.argv[1:], T_START))
