"""Run one cell of the benchmark on the card:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It prints one JSON line as its last line of
standard output (``perfbench/README.md``).
"""

import time

T0 = time.perf_counter()  # set-up is timed from here: before any import

import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root, not this folder, leads the import path
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
