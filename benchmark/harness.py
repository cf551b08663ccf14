"""One run of one cell: set-up, the measured window, the check, the result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name: the cell in `BENCHMARK.json`,
its configuration in the file that entry names, its traffic mix in
`benchmark/traffic/<traffic>.json` (whose ``kind`` picks a runner of
`runners.py`), its limits in `benchmark/limits/<cell>.json`, and each
per-layer metric's reader in `benchmark/metrics/<metric>.py`.

With ``--trace 0`` the run renders its inputs, builds and warms up the
program (``setup_s``, from process start), then runs whole units of work
(suite passes, pair calls) back to back for at least ``--seconds`` and
reports the cell's end-to-end rate over all the work and all the time of
that window; each unit's wall time is kept, and their count, median,
extremes and the unit farthest from the median are one line on stderr.
`run.py` first binds the process to its card's CPUs with fixed host thread
pools (`placement.py`); the result's ``device.host_cpus`` names the CPUs.
With ``--trace 1`` it runs the traffic's ``trace_units`` units
under `torch.profiler` instead and reports the per-layer metrics. Either
way, the window's last answers are then checked against the plain
reference; the numbers compared, each beside its limit, are the last lines
on stderr and the ``checks`` key, last, of the result: the last line on
stdout.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

from . import placement

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vslam_tpu")  # top-level module names, compared whole

__all__ = ["Cell", "Window", "load_cell", "cache_env", "run_units", "verdict", "run_cell", "main"]


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json entries that this cell reports
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s `BENCHMARK.json` with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (cells: {', '.join(sorted(cells))})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((HERE / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def cache_env(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own nvcc libraries already live in `build/vslam_tpu_torch/`)."""
    cache = root / "build" / "benchmark_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted({k.partition(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))


def _loaded_forbidden() -> bool:
    """True, and the names on stderr, where the process holds JAX or the
    JAX package."""
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark runs the port alone", file=sys.stderr)
    return bool(found)


def _reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class LayerRun(NamedTuple):
    """What a per-layer reader reads: the traced window and its work."""

    kind: str  # the traffic's kind
    trace: object  # trace.Trace
    steps: int  # scan steps (suites) or calls (pairs) traced
    gn_least_s: Optional[float]  # least seconds of the traced GN work at the card's peaks


def _device_info(device) -> dict:
    """The result's ``device``; ``host_cpus`` is the CPU list the run's
    process ran on (`placement.py`)."""
    import torch

    host_cpus = placement.cpulist_text(os.sched_getaffinity(0))
    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type, "count": 1, "memory_peak_bytes": 0,
                "host_cpus": host_cpus}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)), "host_cpus": host_cpus}


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Window(NamedTuple):
    """What `run_units` ran: the units, the window's seconds, the host
    answers of the units whose answers the window fetched, and each unit's
    wall seconds (they sum to ``seconds``; the last holds the close)."""

    units: int
    seconds: float
    answers: list
    unit_seconds: list


def run_units(runner, device, seconds: Optional[float] = None, count: Optional[int] = None) -> Window:
    """Units of work back to back, for at least ``seconds`` or ``count`` of
    them."""
    answers = []
    stamps = [time.perf_counter()]
    while True:
        handle = runner.run()
        stamps.append(time.perf_counter())
        if runner.fetches_each:
            answers.append(handle)
        n = len(stamps) - 1
        if (count is not None and n >= count) or (seconds is not None and stamps[-1] - stamps[0] >= seconds):
            break
    if not runner.fetches_each:
        answers.append(runner.fetch(handle))
    _sync(device)
    stamps[-1] = time.perf_counter()  # the last unit ends when its answers are in
    return Window(n, stamps[-1] - stamps[0], [runner.answer(a) for a in answers], np.diff(stamps).tolist())


def unit_line(unit_seconds) -> str:
    """The window's units on one line: count, median, extremes, and the unit
    farthest from the median, so a slow run shows whether it was slow all
    through or had a stall."""
    u = np.asarray(unit_seconds)
    med = float(np.median(u))
    i = int(np.argmax(np.abs(u - med)))
    return (f"units: {len(u)}, median {med:.6f} s, min {u.min():.6f} s, max {u.max():.6f} s, "
            f"widest gap from the median {u[i] - med:+.6f} s ({(u[i] - med) / med:+.2%}) at unit {i}")


def verdict(gaps: dict, limits: dict):
    """The comparison's rule: (number -> (the run's widest gap, its limit),
    a bool per answer that is over any limit). A gap that is not a number is
    over."""
    numbers = {name: (float(np.max(g)), float(limits[name]["limit"])) for name, g in gaps.items()}
    over = np.zeros(len(next(iter(gaps.values()))), dtype=bool)
    for name, g in gaps.items():
        over |= ~(np.asarray(g) <= numbers[name][1])
    return numbers, over


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float, out=None) -> int:
    """One run; prints the result line on ``out`` (stdout) and returns the
    exit code."""
    import torch

    from . import checks, runners, work
    from .trace import capture

    out = out or sys.stdout
    kind = cell.traffic["kind"]
    t_runner = time.perf_counter()
    runner = runners.RUNNERS[kind](cell.config, cell.traffic, seed, device)
    _sync(device)
    setup_s = time.perf_counter() - t0
    runner_s = time.perf_counter() - t_runner

    if trace:
        from vslam_tpu_torch.utils import timer

        timer.reset()
        window, tr = capture(lambda: run_units(runner, device, count=int(cell.traffic["trace_units"])), timer)
    else:
        window = run_units(runner, device, seconds=seconds)
    n, elapsed, answers = window.units, window.seconds, window.answers
    device_info = _device_info(device)
    if _loaded_forbidden():
        return 3

    # the program's work is done: free its state, then the reference
    inputs, per_run, steps_per_run = runner.inputs, runner.units_per_run, runner.steps_per_run
    runner.release()
    del runner
    if device.type == "cuda":
        torch.cuda.empty_cache()
    agree = all(np.array_equal(a, answers[-1]) for a in answers[:-1])
    check = checks.check(kind, cell.config, inputs, answers[-1])
    numbers, over = verdict(check.gaps, cell.limits)
    units = n * per_run
    per_answer = per_run // len(over)
    correct = agree and not over.any()
    failed = units if not agree else n * int(over.sum()) * per_answer

    metrics = {}
    if trace:
        run = LayerRun(kind, tr, n * steps_per_run, n * work.least_seconds(check.gn_log))
        for m in cell.per_layer:
            v = _reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        print(f"trace: {n} units, {tr.launches} launches, busy {tr.busy_s:.6f} of {tr.window_s:.6f} s, "
              f"GN kernel {tr.kernel_s('solve_level_kernel'):.6f} s, its least {run.gn_least_s:.6f} s",
              file=sys.stderr)
    else:
        measured = {"setup_s": setup_s, cell.traffic["rate_metric"]: units / elapsed}
        for m in cell.end_to_end:
            if m["name"] in measured:
                metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}

    if _loaded_forbidden():
        return 3
    result = {"correct": bool(correct), "attempted": int(units), "failed": int(failed), "metrics": metrics,
              "device": device_info}
    if trace:
        result["breakdown"] = tr.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in numbers.items()}
    result["checks"]["passes_agree"] = {"value": int(agree), "limit": 1}
    print(f"{cell.name}: {n} units in {elapsed:.3f} s, setup {setup_s:.3f} s ({runner_s:.3f} s of it the runner: "
          f"inputs, kernels, warm-up), seed {seed}", file=sys.stderr)
    print(unit_line(window.unit_seconds), file=sys.stderr)
    for name, (v, lim) in numbers.items():
        print(f"check {name} {v:.6g} limit {lim:.6g}", file=sys.stderr)
    print(f"check passes_agree {int(agree)} limit 1 ({int(over.sum())} of {len(over)} answers over a limit)",
          file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t0: Optional[float] = None, where: Optional[placement.Placement] = None) -> int:
    """A run as `run.py` starts it; ``where`` is the process's placement,
    made before numpy or torch were imported."""
    t0 = time.perf_counter() if t0 is None else t0
    args = _args(argv)
    cache_env()
    cell = load_cell(args.workload)
    import torch

    if where is not None:
        torch.set_num_threads(where.threads)
        print(f"placement: CPUs {placement.cpulist_text(where.cpus)} ({where.source}), {where.threads} host threads",
              file=sys.stderr)

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    return run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t0)

