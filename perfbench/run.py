"""Run one benchmark cell: ``python3 perfbench/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>`` from the root of the repository.

Prints the cell's result as one JSON line, last on standard output, and the
numbers its correctness was decided on, last on standard error. Exits
nonzero with no result when the GPUs the cell asks for are missing.
"""

import time

T_PROCESS = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_process=T_PROCESS))
