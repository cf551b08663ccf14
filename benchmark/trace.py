"""A traced window under `torch.profiler`, reduced to what the readers use.

`capture` runs a piece of timed work under the profiler (CPU and CUDA
activities, no shapes, no stacks) and returns a `Trace`: the traced
window's length on the host clock, the seconds in which an operation ran on
the device (the union of kernel, copy and set intervals), device seconds by
operation name, the host's launch calls (``cudaLaunch*`` and ``cuLaunch*``,
whoever makes them), the longest idle gaps of the device, each named by the
innermost host event running at the gap's middle, and, for each of the
program's own `utils.timer` spans (marked in the trace by `marked_spans`),
its host seconds and the part of them spent inside CUDA runtime or driver
calls (``cuda*``, ``cu*``), where the host blocks once the launch queue is
full and so waits on the card's pace. The raw Kineto events
are read directly: building the profiler's event tree for the hundreds of
thousands of events of a suite pass takes longer than the pass.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

__all__ = ["Trace", "capture", "marked_spans", "reduce_events"]

_LAUNCH = ("cudaLaunch", "cuLaunch")
_DRIVER = re.compile(r"^cu(da)?[A-Z]")  # a CUDA runtime or driver API call
ATTEMPTS = 3  # CUPTI now and then delivers no device record of a window


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    device_s: Dict[str, float]  # device seconds by operation name
    launches: int
    gaps: List[Tuple[str, float]]  # the longest idle gaps, longest first
    spans: Dict[str, Tuple[float, float]]  # span -> (host s, of them s inside CUDA API calls)

    def kernel_s(self, part: str) -> float:
        """Device seconds of the operations whose name contains ``part``."""
        return sum(s for name, s in self.device_s.items() if part in name)

    def breakdown(self, n: int = 10) -> dict:
        top = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[name[:96], s] for name, s in top],
                "idle_gaps": [[name[:96], s] for name, s in self.gaps[:n]]}


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _inside(api, starts, a, b) -> int:
    """Nanoseconds of the merged intervals ``api`` (sorted, ``starts`` their
    starts) that fall inside [a, b]."""
    total = 0
    for i in range(max(bisect.bisect_right(starts, a) - 1, 0), len(api)):
        lo, hi = api[i]
        if lo >= b:
            break
        total += max(0, min(hi, b) - max(lo, a))
    return total


def reduce_events(events, window_s: float, n_gaps: int = 10, span_names=()) -> Trace:
    """A `Trace` from raw Kineto events (``name()``, ``device_type()``,
    ``start_ns()``, ``end_ns()``); host events named in ``span_names`` are
    the program's spans."""
    cuda = torch.autograd.DeviceType.CUDA
    device, host, api, marked = [], [], [], []
    device_s: Dict[str, float] = defaultdict(float)
    launches = 0
    for e in events:
        name, a, b = e.name(), e.start_ns(), e.end_ns()
        if e.device_type() == cuda:
            if name in span_names:
                continue  # the profiler mirrors a marked range on the device's timeline: no device work
            device.append((a, b))
            device_s[name] += (b - a) * 1e-9
        else:
            launches += name.startswith(_LAUNCH)
            host.append((a, b, name))
            if _DRIVER.match(name):
                api.append((a, b))
            elif name in span_names:
                marked.append((a, b, name))
    busy = _union(device)
    busy_s = sum(b - a for a, b in busy) * 1e-9
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)),
                  reverse=True)[:n_gaps]
    named = []
    for length, a, b in gaps:
        mid = (a + b) / 2
        inner = [(hb - ha, name) for ha, hb, name in host if ha <= mid <= hb]
        named.append((min(inner)[1] if inner else "host idle", length * 1e-9))
    api = _union(api)
    starts = [lo for lo, _ in api]
    spans: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0.0])
    for a, b, name in marked:
        spans[name][0] += (b - a) * 1e-9
        spans[name][1] += _inside(api, starts, a, b) * 1e-9
    return Trace(window_s, busy_s, dict(device_s), launches, named, {k: tuple(v) for k, v in spans.items()})


@contextlib.contextmanager
def marked_spans(timer, names: set):
    """While open, each span that the program opens with ``timer.scope``
    (its `utils.timer` module) is also a `record_function` range of the same
    name, so that the trace holds its start and end; the names opened are
    added to ``names``."""
    from torch.profiler import record_function

    real = timer.scope

    @contextlib.contextmanager
    def scope(name):
        names.add(name)
        with record_function(name), real(name):
            yield

    timer.scope = scope
    try:
        yield
    finally:
        timer.scope = real


def capture(fn: Callable[[], object], timer=None):
    """(fn's result, `Trace`) of ``fn`` run under the profiler from a
    synchronised start to a synchronised end, the program's spans marked
    where ``timer`` (its `utils.timer` module) is given; a window with no
    device record is run again, up to `ATTEMPTS` times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(ATTEMPTS):
        torch.cuda.synchronize()
        names: set = set()
        marking = marked_spans(timer, names) if timer is not None else contextlib.nullcontext()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, marking:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        trace = reduce_events(prof.profiler.kineto_results.events(), window_s, span_names=names)
        if trace.busy_s > 0:
            break
    return out, trace
