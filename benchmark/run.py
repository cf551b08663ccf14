"""The benchmark's command: one run of one cell on this machine's card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; see `harness.py` and `README.md`. Before
numpy or torch start a thread, the process is bound to its card's CPUs with
fixed host thread pools (`placement.py`).
"""

import time

T0 = time.perf_counter()  # set-up runs from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from benchmark import placement

    where = placement.place()
    from benchmark import harness

    sys.exit(harness.main(t0=T0, where=where))
