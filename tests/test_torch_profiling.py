"""The port's profiling helpers (`vslam_tpu_torch.utils.profiling`) against
`tests/test_profiling.py`'s cases: `trace` writes a Chrome trace in which
an `annotate` span shows under its name (the JAX function's TraceAnnotation
role), and `device_memory_stats` is empty on the CPU, as the JAX function
is on backends without allocator stats. Its values on the card are held in
`tests/test_torch_cuda.py`."""

import json
import os

import torch

from vslam_tpu.utils import profiling as jprofiling
from vslam_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)


def test_annotate_span_shows_in_the_trace(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.trace(d):
        with profiling.annotate("solve"):
            x = torch.ones(32, 32) @ torch.ones(32, 32)
        with profiling.annotate("viz.publish"):
            x = x + 1.0
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"solve", "viz.publish"} <= names
    spans = [e for e in events if e.get("name") == "solve" and e.get("ph") == "X"]
    assert spans and spans[0]["dur"] >= 0


def test_annotate_outside_a_trace_is_harmless():
    with profiling.annotate("no profiler"):
        y = torch.arange(4.0).sum()
    assert float(y) == 6.0


def test_device_memory_stats_empty_on_the_cpu():
    import jax

    assert profiling.device_memory_stats("cpu") == {}
    assert jprofiling.device_memory_stats(jax.devices("cpu")[0]) == {}
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}
