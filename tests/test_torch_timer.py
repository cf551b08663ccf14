"""The port's span and counter registry (`vslam_tpu_torch.utils.timer`).

On the CPU: spans keep the spans that enclose them on their thread, and
``within=`` selects by them; host and tensor counters sum when read; with no
profiler recording a scope makes no CUDA event and a counter keeps no
tensor; under a profiler the device markers are read as the stream time
between them (timing events on a hand-moved clock stand in for the card's);
`profiling.trace` exports each span once, nested as opened; a benchmark
traced window (`benchmark.trace.marked_spans` under `capture`) marks each
span once; and the spans and counters sit where the program's layers
launch their work: the scan step, frame build, precompute and the level
solves, with the GN iteration counter equal to the solver's own history.
"""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import trace as bench_trace
from vslam_tpu_torch import bench
from vslam_tpu_torch.alignment import ic
from vslam_tpu_torch.alignment.ic import AlignmentConfig
from vslam_tpu_torch.core.camera import Camera
from vslam_tpu_torch.core.se3 import SE3
from vslam_tpu_torch.io import synthetic
from vslam_tpu_torch.odometry.sequential import SequentialConfig
from vslam_tpu_torch.parallel import sequences
from vslam_tpu_torch.utils import profiling, timer
from vslam_tpu_torch.utils.tree import tree_map
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

FUSED = dataclasses.replace(AlignmentConfig(), sampler="fused_gn", max_points=256)


@pytest.fixture(autouse=True)
def fresh_registry():
    timer.reset()
    yield
    timer.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


class FakeEvent:
    """A CUDA timing event on a clock the test moves by hand (ms)."""

    clock = [0.0]

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self):
        self.t = FakeEvent.clock[0]

    def synchronize(self):
        assert self.t is not None

    def elapsed_time(self, end):
        return end.t - self.t


def _tick(ms):
    FakeEvent.clock[0] += ms


def test_nested_scopes_record_their_enclosing_spans():
    with timer.scope("outer"):
        with timer.scope("mid"):
            with timer.scope("leaf"):
                pass
        with timer.scope("leaf"):
            pass
    with timer.scope("leaf"):
        pass
    assert [r.parents for r in timer._RECORDS["leaf"]] == [("outer", "mid"), ("outer",), ()]
    assert timer.stats("leaf")["count"] == 3
    assert timer.stats("leaf", within="outer")["count"] == 2
    assert timer.stats("leaf", within="mid")["count"] == 1
    assert timer.stats("mid", within="leaf") == {}
    assert timer.stats("outer")["total_s"] >= timer.stats("mid")["total_s"]


def test_spans_of_another_thread_and_after_an_exception_are_not_enclosed():
    def worker():
        with timer.scope("leaf"):
            pass

    with timer.scope("outer"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    assert timer.stats("leaf")["count"] == 1 and timer.stats("leaf", within="outer") == {}
    with pytest.raises(ValueError):
        with timer.scope("failed"):
            raise ValueError("inside a span")
    with timer.scope("after"):
        pass
    assert timer.stats("failed")["count"] == 1
    assert timer._RECORDS["after"][0].parents == ()


def test_host_and_tensor_counters_sum_at_read():
    timer.count("n", 3)
    with _cpu_profile():
        timer.count("it", torch.tensor([1, 2, 3], dtype=torch.int32))
        timer.count("it", torch.tensor(5))
        timer.count("n", 4)
    assert timer.counter("n") == 7
    assert timer.counter("it") == 11
    assert timer.counter("never") is None
    timer.reset()
    assert timer.counter("n") is None and timer.stats("leaf") == {}


def test_with_no_profiler_a_scope_keeps_no_event_and_no_tensor(monkeypatch):
    made = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)  # as on a card
    monkeypatch.setattr(torch.cuda, "Event", lambda **kw: made.append(kw))
    with timer.scope("span"):
        timer.count("it", torch.ones(4, dtype=torch.int32))
    timer.count("solves", 4)
    assert made == []
    assert timer._RECORDS["span"][0].marks is None and timer.device_seconds("span") is None
    assert timer.counter("it") is None and timer.counter("solves") == 4
    assert "device_mean_ms" not in timer.stats("span")


def test_device_markers_are_read_as_the_stream_time_between_them(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    with _cpu_profile():
        with timer.scope("step"):
            _tick(1.0)
            with timer.scope("child"):
                _tick(2.0)
            _tick(0.5)
        with timer.scope("child"):
            _tick(4.0)
    with timer.scope("child"):  # the profiler has stopped: no markers
        _tick(8.0)
    assert timer.device_seconds("step") == pytest.approx(3.5e-3)
    assert timer.device_seconds("child") == pytest.approx(6e-3)
    assert timer.device_seconds("child", within="step") == pytest.approx(2e-3)
    assert timer.device_seconds("nothing") is None
    assert timer.stats("child")["count"] == 3 and timer.stats("child")["device_mean_ms"] == pytest.approx(3.0)
    assert "device ms" in timer.report()


def test_profiling_trace_holds_each_span_once_nested_as_opened(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.trace(d):
        with timer.scope("outer"):
            with profiling.annotate("viz.publish"):
                x = torch.ones(8, 8) @ torch.ones(8, 8)
            with timer.scope("inner"):
                x = x + 1.0
    assert not timer._ranges
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    spans = {name: [e for e in events if e.get("name") == name and e.get("ph") == "X"
                    and not str(e.get("cat", "")).startswith("gpu")]
             for name in ("outer", "viz.publish", "inner")}
    assert {name: len(v) for name, v in spans.items()} == {"outer": 1, "viz.publish": 1, "inner": 1}
    (o,), (v,), (i,) = spans["outer"], spans["viz.publish"], spans["inner"]
    eps = 0.01  # us: the export rounds
    for e in (v, i):
        assert o["ts"] - eps <= e["ts"] and e["ts"] + e["dur"] <= o["ts"] + o["dur"] + eps
    assert v["ts"] + v["dur"] <= i["ts"] + eps
    assert timer.stats("viz.publish", within="outer")["count"] == 1


def test_a_benchmark_traced_window_marks_each_span_once(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)  # no card here
    real = timer.scope

    def work():
        with timer.scope("suite.dispatch"):
            with timer.scope("scan.step"):
                time.sleep(0.02)

    _, tr = bench_trace.capture(work, timer)
    assert timer.scope is real
    host, _ = tr.spans["suite.dispatch"]
    assert host == pytest.approx(timer._RECORDS["suite.dispatch"][-1].seconds, rel=0.25)
    assert 0.0 < tr.spans["scan.step"][0] <= host
    assert timer._RECORDS["scan.step"][-1].parents == ("suite.dispatch",)


def test_gn_iteration_counter_equals_the_solver_history():
    B = 3
    pb = bench.pair_batch(B, 48, 64, device="cpu")
    ref = tree_map(lambda x: x[:, None], pb.ref)
    rel0 = SE3(pb.rel0.R[:, None], pb.rel0.t[:, None])
    with _cpu_profile():
        *_, diag = ic.align(ref, pb.cur, rel0, pb.x_pred[:, None], FUSED, with_diagnostics=True)
    levels = len(pb.cur.intensity)
    assert int(diag["iterations"].sum()) > 0
    assert timer.counter("align.gn_iterations") == int(diag["iterations"].sum())
    assert timer.counter("align.gn_solves") == B * levels
    for name in ("align.solve", "align.precompute"):
        assert timer.stats(name, within="align")["count"] == levels


def _stream(n, seed, H=48, W=64):
    fx = 525.0 * W / 640
    K = synthetic.camera_matrix(fx, fx, (W - 1) / 2, (H - 1) / 2)
    scene = synthetic.default_scene(seed=seed)
    items = []
    for i in range(n):
        T = np.eye(4)
        T[:3, 3] = [0.004 * i, -0.002 * i, 0.003 * i]
        inten, depth = synthetic.render(K, T, (H, W), scene)
        items.append((i * 33_333_333, np.clip(np.round(inten), 0, 255).astype(np.uint8),
                      np.clip(np.round(depth * 5000.0), 0, 65535).astype(np.uint16)))
    return Camera.create(fx, fx, (W - 1) / 2, (H - 1) / 2, device="cpu"), items


def test_the_scan_spans_sit_where_each_layer_launches_its_work(monkeypatch):
    S, F, levels = 2, 5, 2
    cams, streams = zip(*(_stream(F, seed) for seed in range(S)))
    cfg = SequentialConfig(alignment=FUSED, depth_scale=1.0 / 5000.0, n_levels=levels)
    odo = sequences.MultiSequenceOdometry(list(cams), cfg, chunk=2)
    svd_stacks, real_svd = [], np.linalg.svd

    def svd(a):
        svd_stacks.append(timer._local.stack)
        return real_svd(a)

    monkeypatch.setattr(np.linalg, "svd", svd)
    with _cpu_profile():
        out = odo.run([iter(s) for s in streams])
    steps = F - 1
    assert [len(t) for t in out] == [F] * S
    assert timer.stats("scan.step")["count"] == steps
    assert timer.stats("frame.build", within="scan.step")["count"] == steps
    assert timer.stats("frame.build")["count"] == steps + 1  # and the first frames'
    assert timer.stats("align.precompute", within="scan.step")["count"] == steps * levels
    assert timer.stats("align.precompute")["count"] == (steps + 1) * levels
    assert timer.stats("align.solve", within="scan.step")["count"] == steps * levels
    assert timer.stats("suite.init_states")["count"] == 1
    assert timer.stats("suite.collect")["count"] == 2
    # the host's SVDs of the poses run inside the collect span
    assert len(svd_stacks) == steps * S and all(st[-1] == "suite.collect" for st in svd_stacks)
    assert timer.counter("align.gn_solves") == steps * levels * S
    assert timer.counter("align.gn_iterations") > 0
