"""Per-stage performance tracking (role of the reference's easylogging++
TIMED_FUNC/TIMED_SCOPE wrappers around processFrame/solve/levels,
GaussNewton.cpp:36,45, SE3Alignment.cpp:69,111, NodeMapping.cpp:145).

A process-wide registry of named timers with context-manager scoping;
`report()` gives count/mean/p95/max per stage. For on-device sections pair
with an explicit sync (the pipeline's per-frame host fetch is one), or use
torch.profiler for kernel-level traces. A copy of `vslam_tpu.utils.timer`
(numpy only): the port must run where JAX is not installed.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np

__all__ = ["scope", "record", "report", "reset", "stats"]

_TIMES: Dict[str, List[float]] = defaultdict(list)


@contextlib.contextmanager
def scope(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _TIMES[name].append(time.perf_counter() - t0)


def record(name: str, seconds: float) -> None:
    _TIMES[name].append(seconds)


def stats(name: str) -> Dict[str, float]:
    xs = np.asarray(_TIMES.get(name, []))
    if len(xs) == 0:
        return {}
    return {
        "count": int(len(xs)),
        "mean_ms": float(xs.mean() * 1e3),
        "p95_ms": float(np.percentile(xs, 95) * 1e3),
        "max_ms": float(xs.max() * 1e3),
        "total_s": float(xs.sum()),
    }


def report() -> str:
    lines = [f"{'stage':<28}{'count':>7}{'mean ms':>10}{'p95 ms':>10}{'max ms':>10}"]
    for name in sorted(_TIMES):
        s = stats(name)
        lines.append(
            f"{name:<28}{s['count']:>7}{s['mean_ms']:>10.2f}{s['p95_ms']:>10.2f}{s['max_ms']:>10.2f}"
        )
    return "\n".join(lines)


def reset() -> None:
    _TIMES.clear()
