"""The control, the plain reference computed in bfloat16 (the next precision
below the configurations' float32) in the program's place, comes out not
correct under the harness's own comparison: `checks.check` on the control's
answers, then `harness.verdict` under the cell's limits, as `run_cell` does
with the program's answers. On the CPU at a small size for the suite (the
pair cell's CPU case is `test_bm_reference.test_control_fails_the_pair_limit`),
and on a card at each cell's own size."""

import pytest
import torch

from benchmark import checks, harness, scenes
from small import small_cell

INPUTS = {"suite": scenes.suite_inputs, "pairs": scenes.pair_inputs}


def _control_over(cell, seed, device):
    kind = cell.traffic["kind"]
    inputs = INPUTS[kind](cell.config, cell.traffic, seed, device)
    Rc, tc, _ = checks.RUNS[kind](cell.config, inputs, torch.bfloat16)
    check = checks.check(kind, cell.config, inputs, checks.transforms(Rc, tc))
    numbers, over = harness.verdict(check.gaps, cell.limits)
    return numbers, over


def test_control_is_not_correct_in_a_small_suite():
    # 16 sequences: the control's widest gaps grow with the sequences it tracks
    cell = small_cell("tum_suite", sequences=16, frames=32, chunk=16)
    numbers, over = _control_over(cell, 6, torch.device("cpu"))
    assert over.any(), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tum_suite", "tum_pairs_b1024"])
def test_control_is_not_correct_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    numbers, over = _control_over(harness.load_cell(name), 31337, torch.device("cuda", 0))
    assert over.any(), numbers
