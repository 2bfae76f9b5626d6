"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic mix are looked up by name in
``BENCHMARK.json`` and ``benchmark/{configs,traffic}/``; see ``harness``.
"""

import time

T_START = time.perf_counter()   # set-up is timed from here, imports included

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

if __name__ == "__main__":
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT))
    from harness import env

    env.fix(ROOT)
    from harness.main import main

    sys.exit(main(sys.argv[1:], ROOT, T_START))
