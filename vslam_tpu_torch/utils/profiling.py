"""Device tracing and memory statistics (port of `vslam_tpu.utils.profiling`).

``trace(dir)`` wraps a region in `torch.profiler` and writes a Chrome trace
(`trace.json`, chrome://tracing or Perfetto) into ``dir``: the host ops and,
on CUDA, every kernel with its device time. The CLI's ``--profile-dir``
uses it. ``annotate(name)`` names a span inside it, and
``device_memory_stats()`` reads the caching allocator's counters.

Not ported, with their reasons:

- ``cost_analysis``: XLA's static cost model of a compiled program; a
  PyTorch program is not compiled ahead of its run.
- ``tpu_peaks``: TPU spec-sheet peaks; the port runs on no TPU.
- ``fused_align_flops`` and ``banded_segments_from_data``: they count the
  work of the Pallas kernel's one-hot, 128-row banded sampling, a layout
  the port's CUDA kernels, which load pixels directly, do not have.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict

__all__ = ["trace", "annotate", "device_memory_stats"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the wrapped region into ``log_dir``/trace.json;
    wrap exactly the region of interest, as traces of whole replays are
    large. Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named sub-span inside an active trace (a `torch.profiler.
    record_function` range, under its name in trace.json), as the
    reference's TIMED_SCOPE names show in its perf logs."""
    from torch.profiler import record_function

    return record_function(name)


# the JAX function's keys (the XLA allocator's names) that the caching
# allocator's counters fill
_STATS = {
    "bytes_in_use": "allocated_bytes.all.current",
    "peak_bytes_in_use": "allocated_bytes.all.peak",
    "bytes_reserved": "reserved_bytes.all.current",
    "peak_bytes_reserved": "reserved_bytes.all.peak",
    "num_allocs": "allocation.all.allocated",
}


def device_memory_stats(device=None) -> Dict[str, int]:
    """Live allocator stats of ``device`` (default: the current CUDA device)
    under the JAX function's key names, as ints; ``bytes_limit`` is the
    card's total memory. Empty on the CPU, as the JAX function is on
    backends without memory stats."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    out = {key: int(stats.get(name, 0)) for key, name in _STATS.items()}
    out["bytes_limit"] = int(torch.cuda.mem_get_info(device)[1])
    return out
