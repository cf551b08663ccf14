"""Device tracing (port of `vslam_tpu.utils.profiling.trace`).

``trace(dir)`` wraps a region in `torch.profiler` and writes a Chrome trace
(`trace.json`, chrome://tracing or Perfetto) into ``dir``: the host ops and,
on CUDA, every kernel with its device time. The CLI's ``--profile-dir``
uses it. The JAX module's XLA cost model, TPU peaks and FLOP model have no
counterpart here.
"""

from __future__ import annotations

import contextlib
import os

__all__ = ["trace"]


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
