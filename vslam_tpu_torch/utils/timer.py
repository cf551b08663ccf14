"""Per-stage performance tracking: the port's one registry of program spans
and counters (role of the reference's easylogging++ TIMED_FUNC/TIMED_SCOPE
wrappers around processFrame/solve/levels, GaussNewton.cpp:36,45,
SE3Alignment.cpp:69,111, NodeMapping.cpp:145).

``scope(name)`` times a span on the host clock and keeps, with each record,
the spans that enclosed it on the same thread, outermost first, so that
``stats(name, within=...)`` and ``device_seconds(name, within=...)`` select
the records opened inside a named span; a layer's self time is its span
less its children's. `report()` gives count/mean/p95/max per stage.

While a `torch.profiler` session records and CUDA is in use, a scope also
records a pair of CUDA events on the current stream at its entry and exit.
They stay pending until read: ``device_seconds`` resolves them, after a
synchronise, into the stream time between each span's markers, that is the
device work the span enqueued plus any idle of the stream inside it. An
event record is not a kernel launch.

``count(name, n)`` adds to a counter: a host number always; a 0-dim or 1-dim
tensor only while a profiler records, kept by reference and summed once,
when ``counter(name)`` reads it, so the hot path launches no kernel and
waits for nothing.

With no profiler a scope costs a clock pair, a list append, one flag check
and a push and pop of the thread's span stack: no event is made and no
tensor is kept. Under `utils.profiling.trace` (which sets ``_ranges``) each
scope is also a `record_function` range, so the exported trace.json holds
every program span beside the kernels, on one clock. Call sites go through
the module, ``timer.scope(...)``, so that a tool may wrap the function for
a traced window (the benchmark's `trace.marked_spans` does, and opens the
ranges itself).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.autograd.profiler as _profiler
from torch.profiler import record_function

__all__ = ["scope", "record", "count", "counter", "device_seconds", "report", "reset", "stats"]


class _Record(NamedTuple):
    seconds: float  # host clock
    parents: Tuple[str, ...]  # the enclosing spans on the same thread, outermost first
    marks: Optional[tuple]  # (start, end) CUDA events, or None


_RECORDS: Dict[str, List[_Record]] = defaultdict(list)
_COUNTS: Dict[str, list] = defaultdict(lambda: [0, []])  # name -> [host total, tensors]
_local = threading.local()
_ranges = False  # set by `profiling.trace`: every scope is a record_function range too


def _markers():
    """A started (start, end) pair of timing events on the current CUDA
    stream while a profiler records, else None."""
    if not (_profiler._is_profiler_enabled and torch.cuda.is_initialized()):
        return None
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    return start, torch.cuda.Event(enable_timing=True)


@contextlib.contextmanager
def scope(name: str):
    rng = record_function(name) if _ranges else None
    if rng is not None:
        rng.__enter__()
    marks = _markers()
    parents = getattr(_local, "stack", ())
    _local.stack = parents + (name,)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        seconds = time.perf_counter() - t0
        if marks is not None:
            marks[1].record()
        if rng is not None:
            rng.__exit__(None, None, None)
        _local.stack = parents
        _RECORDS[name].append(_Record(seconds, parents, marks))


def record(name: str, seconds: float) -> None:
    _RECORDS[name].append(_Record(seconds, getattr(_local, "stack", ()), None))


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name``: a host number, or a 0-dim or 1-dim
    tensor (its sum), the latter only while a profiler records."""
    if torch.is_tensor(n):
        if _profiler._is_profiler_enabled:
            _COUNTS[name][1].append(n)
    else:
        _COUNTS[name][0] += n


def counter(name: str):
    """The counter's total, its tensors summed now; None where nothing was
    counted under ``name``."""
    if name not in _COUNTS:
        return None
    host, tensors = _COUNTS[name]
    return host + sum(t.sum().item() for t in tensors)


def _select(name: str, within: Optional[str]) -> List[_Record]:
    return [r for r in _RECORDS.get(name, ()) if within is None or within in r.parents]


def device_seconds(name: str, within: Optional[str] = None) -> Optional[float]:
    """Summed stream seconds between the device markers of the records of
    ``name`` (those opened inside a span ``within`` where given); None where
    no such record has markers. Waits for the markers' stream."""
    marks = [r.marks for r in _select(name, within) if r.marks is not None]
    if not marks:
        return None
    for _, end in marks:
        end.synchronize()
    return 1e-3 * sum(start.elapsed_time(end) for start, end in marks)


def stats(name: str, within: Optional[str] = None) -> Dict[str, float]:
    recs = _select(name, within)
    if not recs:
        return {}
    xs = np.asarray([r.seconds for r in recs])
    out = {
        "count": int(len(xs)),
        "mean_ms": float(xs.mean() * 1e3),
        "p95_ms": float(np.percentile(xs, 95) * 1e3),
        "max_ms": float(xs.max() * 1e3),
        "total_s": float(xs.sum()),
    }
    n_marked = sum(r.marks is not None for r in recs)
    if n_marked:
        out["device_mean_ms"] = device_seconds(name, within) * 1e3 / n_marked
    return out


def report() -> str:
    lines = [f"{'stage':<28}{'count':>7}{'mean ms':>10}{'p95 ms':>10}{'max ms':>10}{'device ms':>11}"]
    for name in sorted(_RECORDS):
        s = stats(name)
        device = f"{s['device_mean_ms']:>11.2f}" if "device_mean_ms" in s else f"{'-':>11}"
        lines.append(
            f"{name:<28}{s['count']:>7}{s['mean_ms']:>10.2f}{s['p95_ms']:>10.2f}{s['max_ms']:>10.2f}{device}"
        )
    return "\n".join(lines)


def reset() -> None:
    _RECORDS.clear()
    _COUNTS.clear()
