"""On a card only: one short run of each cell ends correct, with every
metric it should report. Skips without CUDA."""

import io
import json
import time

import pytest
import torch

from benchmark import harness


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tum_suite", "tum_pairs_b1024"])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct_on_the_card(name, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = harness.load_cell(name)
    buf = io.StringIO()
    assert harness.run_cell(cell, 424242, 2.0, trace, torch.device("cuda", 0), time.perf_counter(), out=buf) == 0
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    wanted = cell.per_layer if trace else cell.end_to_end
    assert {m["name"] for m in wanted} <= set(result["metrics"])
