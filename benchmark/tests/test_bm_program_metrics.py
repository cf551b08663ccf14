"""The readers of the program's own spans and counters (`program.py` and the
ten `metrics/*` files that use it): None on the other cell's kind and where
their span or counter is absent; the right number from a hand-made
registry (timing events on a hand-moved clock in place of the card's) and
trace; and, on a card only, the spans account for the device's busy time
of a traced suite and pair batch."""

import io
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from benchmark.trace import Trace
from vslam_tpu_torch.utils import timer

SUITE = ["frame_build_ms_per_step.suite", "precompute_ms_per_step.suite", "solve_ms_per_step.suite",
         "step_rest_ms_per_step.suite", "gn_iterations_per_solve.suite", "collect_ms_per_step.suite",
         "init_ms_per_step.suite"]
PAIRS = ["precompute_ms_per_call.pairs", "solve_ms_per_call.pairs", "gn_iterations_per_solve.pairs"]


class FakeEvent:
    clock = [0.0]  # ms

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = FakeEvent.clock[0]

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def _tick(ms):
    FakeEvent.clock[0] += ms


def _trace(spans=None):
    return Trace(1.0, 0.9, {}, 0, [], spans or {})


@pytest.fixture
def registry(monkeypatch):
    timer.reset()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    yield
    timer.reset()


def _scan_steps(steps=2):
    """The scan's spans as `odometry/sequential` opens them: a first frame
    built and precomputed outside every step, then ``steps`` steps of frame
    build 3 ms, two levels' precompute 1 ms each, and `align` with two
    level solves 0.5 ms each and 0.25 ms of glue, and 1 ms of the rest."""
    with profile(activities=[ProfilerActivity.CPU]):
        with timer.scope("frame.build"):
            _tick(3.0)
        for _ in range(2):
            with timer.scope("align.precompute"):
                _tick(1.0)
        for _ in range(steps):
            with timer.scope("scan.step"):
                with timer.scope("frame.build"):
                    _tick(3.0)
                for _ in range(2):
                    with timer.scope("align.precompute"):
                        _tick(1.0)
                with timer.scope("align"):
                    for _ in range(2):
                        with timer.scope("align.solve"):
                            _tick(0.5)
                        timer.count("align.gn_solves", 4)
                        timer.count("align.gn_iterations", torch.tensor([3, 4, 5, 6]))
                    _tick(0.25)
                _tick(1.0)


def _pair_calls(calls=2):
    """`align_pairs` calls as `alignment/ic` opens their spans: per level a
    precompute of 1 ms and a solve of 2 ms, two levels, 0.5 ms of glue."""
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(calls):
            with timer.scope("align"):
                for _ in range(2):
                    with timer.scope("align.precompute"):
                        _tick(1.0)
                    with timer.scope("align.solve"):
                        _tick(2.0)
                    timer.count("align.gn_solves", 2)
                    timer.count("align.gn_iterations", torch.tensor([7, 9]))
                _tick(0.5)


@pytest.mark.parametrize("name", SUITE + PAIRS)
def test_none_on_the_other_kind_and_without_the_span(name, registry):
    kind = "suite" if name in SUITE else "pairs"
    other = "pairs" if kind == "suite" else "suite"
    read = harness._reader(name)
    spans = {"suite.collect": (0.5, 0.1), "suite.init_states": (0.2, 0.05)}
    assert read(harness.LayerRun(kind, _trace(), 2, None)) is None  # nothing recorded
    _scan_steps() if kind == "suite" else _pair_calls()
    assert read(harness.LayerRun(other, _trace(spans), 2, None)) is None
    timer.reset()
    with timer.scope("scan.step"):  # spans, but no profiler: no markers, no tensor
        with timer.scope("align"):
            timer.count("align.gn_iterations", torch.tensor([1]))
            timer.count("align.gn_solves", 1)
    assert read(harness.LayerRun(kind, _trace(), 1, None)) is None


def test_suite_readers_read_the_registry_and_the_trace(registry):
    _scan_steps(steps=2)
    spans = {"suite.collect": (0.5, 0.1), "suite.init_states": (0.2, 0.05), "suite.dispatch": (0.3, 0.2)}
    run = harness.LayerRun("suite", _trace(spans), 2, None)
    got = {name: harness._reader(name)(run) for name in SUITE}
    assert got == pytest.approx({
        "frame_build_ms_per_step.suite": 3.0,
        "precompute_ms_per_step.suite": 2.0,
        "solve_ms_per_step.suite": 1.0,
        "step_rest_ms_per_step.suite": 1.25,  # the glue inside `align` and the rest
        "gn_iterations_per_solve.suite": 4.5,
        "collect_ms_per_step.suite": 200.0,
        "init_ms_per_step.suite": 75.0,
    })


def test_pair_readers_read_the_registry(registry):
    _pair_calls(calls=2)
    run = harness.LayerRun("pairs", _trace(), 2, None)
    got = {name: harness._reader(name)(run) for name in PAIRS}
    assert got == pytest.approx({"precompute_ms_per_call.pairs": 2.0, "solve_ms_per_call.pairs": 4.0,
                                 "gn_iterations_per_solve.pairs": 8.0})


@pytest.mark.cuda
@pytest.mark.parametrize("name,traffic,parts", [
    ("tum_suite", {"frames": 12, "chunk": 4}, SUITE[:4]),
    ("tum_pairs_b1024", {}, PAIRS[:2]),
])
def test_spans_account_for_the_device_busy_time(name, traffic, parts):
    """Criterion of the layer split: the spans' device time, per step or
    call, times the steps or calls, lies within [0.85, 1.05] of the traced
    window's busy time (the rest of busy is the pass's first frames and
    fetches). The markers also count the stream's idle inside the spans, so
    the batch has to set the card's pace: the suite keeps its 512 sequences
    (a shorter pass), the pairs their 1024 (at 512 the host sets the pace:
    idle 41 %, the spans 1.10 of busy)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = harness.load_cell(name)
    cell = cell._replace(traffic=dict(cell.traffic, **traffic))
    buf = io.StringIO()
    assert harness.run_cell(cell, 2**31 + 12345, 2.0, True, torch.device("cuda", 0), time.perf_counter(),
                            out=buf) == 0
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    units = timer.stats("scan.step" if cell.traffic["kind"] == "suite" else "align")["count"]
    accounted = sum(result["metrics"][p]["value"] for p in parts) * 1e-3 * units
    assert 0.85 <= accounted / result["device"]["busy_s"] <= 1.05, (accounted, result["device"])
