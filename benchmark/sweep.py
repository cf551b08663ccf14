"""A cell run at other sizes of its traffic, in one process, on the card.

    python3 benchmark/sweep.py --workload tum_suite --key sequences --values 128,256,512 --seed 7 --trace 1

Each value replaces ``key`` in the cell's traffic file for one run of
`harness.run_cell` (``--seconds`` as the benchmark's), which prints its
result line as the benchmark does; sizing a cell is the use. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--key", required=True)
    p.add_argument("--values", required=True, help="comma-separated whole numbers")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    harness.cache_env()
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("sweep.py needs a CUDA device", file=sys.stderr)
        return 2
    for value in (int(v) for v in args.values.split(",")):
        traffic = dict(cell.traffic, **{args.key: value})
        print(f"sweep {args.key}={value}", file=sys.stderr, flush=True)
        torch.cuda.reset_peak_memory_stats()
        rc = harness.run_cell(cell._replace(traffic=traffic), args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), time.perf_counter())
        if rc:
            return rc
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
