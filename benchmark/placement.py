"""Where a run's host side runs: the CPUs next to its card, a fixed number of
host threads.

A deployment binds a card's feeding process to the CPUs of the card's own
NUMA node and fixes its thread pools. `place` does that for the run's own
process, before numpy or torch start a thread pool: it binds the process
(`os.sched_setaffinity` on its own pid) to the card's ``local_cpulist``
read from sysfs, and sets ``OMP_NUM_THREADS``, ``OPENBLAS_NUM_THREADS`` and
``MKL_NUM_THREADS`` to `HOST_THREADS` (the harness sets torch's intra-op
pool to the same count once torch is imported). It changes nothing on the
machine. Where sysfs names no card or no CPU list that the process may use
(no card, a CPU-only machine), the process keeps the CPUs it inherited and
says so.

This module imports nothing but the standard library: `run.py` calls it
before anything starts a thread.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, NamedTuple

__all__ = ["HOST_THREADS", "Placement", "cpulist", "cpulist_text", "card_cpus", "place"]

HOST_THREADS = 8  # torch intra-op and BLAS pools: the steadiest of 2, 4 and 8 in turns on a card (PERF.md §2)
SYSFS_PCI = Path("/sys/bus/pci/devices")
_NVIDIA = "0x10de"
_DISPLAY = "0x03"  # PCI class 03xxxx: display controllers (an H100 is 0x030200)
_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


class Placement(NamedTuple):
    cpus: List[int]  # the CPUs the run may use
    source: str  # where the list came from, for the stderr line
    threads: int


def cpulist(text: str) -> List[int]:
    """The CPUs of a kernel CPU list such as ``0-3,8,10-11``."""
    cpus = set()
    for part in text.strip().split(","):
        if part.strip():
            a, _, b = part.partition("-")
            cpus.update(range(int(a), int(b or a) + 1))
    return sorted(cpus)


def cpulist_text(cpus) -> str:
    """The kernel's compact form of a CPU list: ``0-3,8``."""
    runs = []
    for c in sorted(cpus):
        if runs and c == runs[-1][1] + 1:
            runs[-1][1] = c
        else:
            runs.append([c, c])
    return ",".join(str(a) if a == b else f"{a}-{b}" for a, b in runs)


def _read(path: Path) -> str:
    try:
        return path.read_text().strip()
    except OSError:
        return ""


def _cards(sysfs: Path) -> List[Path]:
    """NVIDIA display devices in bus order: CUDA's own order for cards of one
    kind, so the first is the run's device 0."""
    if not sysfs.is_dir():
        return []
    return [d for d in sorted(sysfs.iterdir())
            if _read(d / "vendor") == _NVIDIA and _read(d / "class").startswith(_DISPLAY)]


def card_cpus(sysfs: Path = SYSFS_PCI):
    """(CPUs, source): the first card's local CPUs that the process may use,
    or the inherited CPUs where sysfs gives none."""
    inherited = sorted(os.sched_getaffinity(0))
    cards = _cards(Path(sysfs))
    if not cards:
        return inherited, "inherited: sysfs names no NVIDIA card"
    card = cards[0]
    local = set(cpulist(_read(card / "local_cpulist"))) & set(inherited)
    if not local:
        return inherited, f"inherited: card {card.name} gives no local CPU list that the process may use"
    node = _read(card / "numa_node") or "unknown"
    return sorted(local), f"card {card.name}'s local CPUs (NUMA node {node})"


def place(threads: int = HOST_THREADS, sysfs: Path = SYSFS_PCI) -> Placement:
    """Bind this process to its card's CPUs and fix its host thread pools."""
    cpus, source = card_cpus(sysfs)
    os.sched_setaffinity(0, cpus)
    for var in _THREAD_VARS:
        os.environ[var] = str(threads)
    return Placement(cpus, source, threads)
