"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json`` and the port
(``subgc_tpu_torch``), on a machine with the CUDA devices the cell asks
for.  Earlier lines of standard output say what ran; the last is the
result, one JSON object.  See ``portbench/harness.py``.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if __name__ == "__main__":
    from portbench.harness import main
    sys.exit(main(t_start=T_START))
