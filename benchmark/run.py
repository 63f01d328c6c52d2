"""Run one cell of the benchmark once and print its result as the last line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  See benchmark/harness/runner.py.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(t0=T0))
