"""Run one cell of BENCHMARK.json once, from the root of a checkout:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result's JSON object; the numbers
compared with the reference, each beside its limit, are the last lines
of standard error. Exits non-zero, printing no result, without a card (or
with fewer cards than the cell asks for), and when the process has loaded
JAX or the JAX package.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(sys.argv[1:], T0))
