"""The readings a cell's limit is set from, on the card, in one process.

    python3 benchmark/control.py --workload tum_suite --seeds 11,12,13 --control-seeds 11,12,13

For each seed: the cell's set-up (its inputs and the program, warmed up),
one unit of the timed path (a suite pass, a pair call), then the plain
reference in float32, the configuration's precision: the program's widest
pose gap is a sound run's reading. For each control seed the reference is
run again in bfloat16, the next precision below, in the program's place, and
its widest gap against the float32 reference is the control's reading, and
``control.correct`` what the harness's own rule (`harness.verdict`) makes of
it under the cell's limits. The limit in `limits/<cell>.json` lies between
the largest sound reading and the smallest control reading. One JSON line a seed, then a summary, on stdout.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import checks, harness, runners  # noqa: E402

__all__ = ["readings"]


def readings(cell: harness.Cell, seed: int, control: bool, device) -> dict:
    kind = cell.traffic["kind"]
    runner = runners.RUNNERS[kind](cell.config, cell.traffic, seed, device)
    answers = harness.run_units(runner, device, count=1).answers
    inputs = runner.inputs
    runner.release()
    del runner
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    R, t, log = checks.RUNS[kind](cell.config, inputs)
    out = {"seed": seed, "reference_s": time.perf_counter() - t0}
    gaps = checks.GAPS[kind](answers[-1], R, t)
    out["evals"] = int(sum(int(e["evals"].sum()) for e in log))
    out["program.correct"] = not harness.verdict(gaps, cell.limits)[1].any()
    for name, g in gaps.items():
        out[f"program.{name}"] = float(np.max(g))
        out[f"program.{name}.median"] = float(np.median(g))
    if control:
        Rc, tc, _ = checks.RUNS[kind](cell.config, inputs, torch.bfloat16)
        control = checks.GAPS[kind](checks.transforms(Rc, tc), R, t)
        for name, g in control.items():
            out[f"control.{name}"] = float(np.max(g))
            out[f"control.{name}.median"] = float(np.median(g))
        out["control.correct"] = not harness.verdict(control, cell.limits)[1].any()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control-seeds", default="", help="comma-separated; a subset of --seeds")
    args = p.parse_args(argv)
    harness.cache_env()
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in seeds:
        row = readings(cell, seed, seed in controls, device)
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": cell.name, "device": torch.cuda.get_device_name(device)}
    for key in rows[0]:
        if key.startswith("program.") and not key.endswith((".median", ".correct")):
            name = key.partition(".")[2]
            summary[f"lower.{name}"] = max(r[key] for r in rows)
            summary[f"upper.{name}"] = min((r[f"control.{name}"] for r in rows if f"control.{name}" in r),
                                           default=None)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
