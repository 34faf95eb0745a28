"""Run one benchmark cell; see ``bench/harness.py``.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root, not this directory, is where imports start
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
