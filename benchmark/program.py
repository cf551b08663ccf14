"""The program's own spans and counters, for the per-layer readers that read
them: the `vslam_tpu_torch.utils.timer` registry after a traced window.

The harness resets the registry just before the window and runs nothing of
the program after it (the plain reference uses none of it), so the registry
holds the traced window alone. A span's device time is the stream time
between the device markers that `utils.timer` records at its entry and exit
while the profiler records on a card: the device work the span enqueued
plus any idle of the stream inside it. Every function returns None where
the registry lacks what it reads: a program whose registry has no markers
or counters, a span or counter the program does not have, a run on the CPU.
"""

from __future__ import annotations

from typing import Iterable, Optional

__all__ = ["units", "device_ms_per", "self_ms_per", "counter_ratio", "host_ms_per_step"]


def _timer():
    from vslam_tpu_torch.utils import timer

    return timer if hasattr(timer, "device_seconds") and hasattr(timer, "counter") else None


def units(span: str) -> Optional[int]:
    """The number of records of ``span`` in the window (scan steps, calls)."""
    timer = _timer()
    return (timer.stats(span).get("count") or None) if timer is not None else None


def device_ms_per(name: str, per: str, within: Optional[str] = None) -> Optional[float]:
    """Device ms of the records of ``name`` (those inside a span ``within``
    where given), per record of the span ``per``."""
    n = units(per)
    seconds = _timer().device_seconds(name, within) if n else None
    return None if seconds is None else 1e3 * seconds / n


def self_ms_per(span: str, children: Iterable[str], per: str) -> Optional[float]:
    """Device ms of ``span`` less that of its ``children`` opened inside it,
    per record of ``per``."""
    parts = [device_ms_per(span, per)] + [device_ms_per(c, per, within=span) for c in children]
    return None if None in parts else parts[0] - sum(parts[1:])


def counter_ratio(num: str, den: str) -> Optional[float]:
    timer = _timer()
    if timer is None:
        return None
    a, b = timer.counter(num), timer.counter(den)
    return None if a is None or not b else a / b


def host_ms_per_step(run, span: str) -> Optional[float]:
    """Host ms a step of the program span ``span`` marked in the trace, less
    the time inside CUDA runtime and driver calls within it (where the host
    waits on the card), over the traced steps."""
    s = run.trace.spans.get(span)
    if not s or not run.steps:
        return None
    return 1e3 * (s[0] - s[1]) / run.steps
