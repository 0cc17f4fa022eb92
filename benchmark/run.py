"""Run one benchmark cell once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's files are found by name under
``benchmark/``; the last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and ``checks`` last), the numbers compared and their limits are
the last lines of standard error. A cell whose traffic has ``ranks: N``
runs as N processes, one card each, that this one starts and is rank 0 of
(``benchmark/harness/ranks.py``). Exits 2 without a result where the cell's
CUDA devices are missing, 3 where JAX or the JAX package was loaded, 1 where
a rank failed.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root, in place of this script's folder
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("USE_FLAX", "0")

from benchmark.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
