"""Where a run's host side runs (`placement.py`) and what the window keeps of
each unit (`harness.run_units`), on the CPU with a fake sysfs tree."""

import io
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness, placement
from small import small_cell

CPU = torch.device("cpu")
INHERITED = sorted(os.sched_getaffinity(0))


def _device(root, name, vendor="0x10de", cls="0x030200", **files):
    d = root / name
    d.mkdir(parents=True)
    (d / "vendor").write_text(vendor + "\n")
    (d / "class").write_text(cls + "\n")
    for f, text in files.items():
        (d / f).write_text(text)
    return d


def test_cpulist_round_trip():
    assert placement.cpulist("0-3,8,10-11\n") == [0, 1, 2, 3, 8, 10, 11]
    assert placement.cpulist_text([11, 0, 1, 2, 3, 8, 10]) == "0-3,8,10-11"
    assert placement.cpulist("") == []


def test_the_card_local_cpus_are_read(tmp_path):
    _device(tmp_path, "0000:00:01.0", vendor="0x8086", cls="0x060400", local_cpulist="0-1\n")
    mine = INHERITED[-1:]
    _device(tmp_path, "0000:18:00.0", local_cpulist=placement.cpulist_text(mine) + "\n", numa_node="1\n")
    _device(tmp_path, "0000:3b:00.0", local_cpulist=placement.cpulist_text(INHERITED) + "\n", numa_node="0\n")
    cpus, source = placement.card_cpus(tmp_path)
    assert cpus == mine
    assert source == "card 0000:18:00.0's local CPUs (NUMA node 1)"


def _no_list(root):
    _device(root, "0000:18:00.0", numa_node="0\n")


def _empty_list(root):
    _device(root, "0000:18:00.0", local_cpulist="\n")


def _foreign_cpus(root):
    _device(root, "0000:18:00.0", local_cpulist=f"{max(INHERITED) + 1}-{max(INHERITED) + 4}\n")


def _no_card(root):
    _device(root, "0000:00:01.0", vendor="0x8086", cls="0x060400", local_cpulist="0\n")


@pytest.mark.parametrize("make", [_no_list, _empty_list, _foreign_cpus, _no_card, None])
def test_fallback_keeps_the_inherited_cpus_and_says_so(tmp_path, make):
    root = tmp_path / "devices"
    if make is not None:
        make(root)
    cpus, source = placement.card_cpus(root)
    assert cpus == INHERITED
    assert source.startswith("inherited: ")


def test_place_binds_the_process_and_fixes_its_threads(tmp_path):
    """In a child process: the affinity and the thread variables are set, and
    placing imports neither numpy nor torch."""
    mine = INHERITED[:1]
    _device(tmp_path, "0000:18:00.0", local_cpulist=placement.cpulist_text(mine) + "\n", numa_node="0\n")
    code = ("import os, sys, json\nfrom benchmark import placement\n"
            f"p = placement.place(3, sysfs={str(tmp_path)!r})\n"
            "print(json.dumps([sorted(os.sched_getaffinity(0)), p.cpus, p.threads,"
            " [os.environ[v] for v in ('OMP_NUM_THREADS', 'OPENBLAS_NUM_THREADS', 'MKL_NUM_THREADS')],"
            " sorted({'numpy', 'torch'} & set(sys.modules))]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=60, check=True)
    assert json.loads(out.stdout) == [mine, mine, 3, ["3", "3", "3"], []]


class _Runner:
    """Units that take known host times; answers fetched each, or at the close."""

    def __init__(self, fetches_each, sleeps=(0.002, 0.004, 0.001, 0.006)):
        self.fetches_each, self.sleeps, self.i = fetches_each, sleeps, 0

    def run(self):
        time.sleep(self.sleeps[self.i % len(self.sleeps)])
        self.i += 1
        return self.i

    def fetch(self, handle):
        time.sleep(0.003)
        return handle

    @staticmethod
    def answer(a):
        return a


@pytest.mark.parametrize("fetches_each", [True, False])
@pytest.mark.parametrize("seconds, count", [(None, 7), (0.05, None)])
def test_run_units_keeps_one_wall_time_a_unit(fetches_each, seconds, count):
    w = harness.run_units(_Runner(fetches_each), CPU, seconds=seconds, count=count)
    assert len(w.unit_seconds) == w.units and w.units >= (count or 1)
    assert abs(sum(w.unit_seconds) - w.seconds) <= 0.01 * w.seconds
    assert min(w.unit_seconds) >= 0.001
    assert w.answers == (list(range(1, w.units + 1)) if fetches_each else [w.units])
    line = harness.unit_line(w.unit_seconds)
    assert line.startswith(f"units: {w.units}, median ") and "widest gap from the median" in line


def test_the_result_keeps_its_keys_and_names_the_host_cpus(capsys):
    buf = io.StringIO()
    assert harness.run_cell(small_cell("tum_pairs_b1024"), 5, 0.0, False, CPU, time.perf_counter(), out=buf) == 0
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes", "host_cpus"}
    assert placement.cpulist(result["device"]["host_cpus"]) == INHERITED
    err = capsys.readouterr().err.splitlines()
    assert err[1].startswith("units: 1, median ")
    assert err[-1].startswith("check passes_agree ")


def test_main_sets_the_threads_and_says_where_it_runs(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    where = placement.Placement(INHERITED, "inherited: a test", 2)
    assert harness.main(["--workload", "tum_suite", "--seed", "1", "--seconds", "1"], where=where) == 2
    assert torch.get_num_threads() == 2
    assert f"placement: CPUs {placement.cpulist_text(INHERITED)} (inherited: a test), 2 host threads" in \
        capsys.readouterr().err
