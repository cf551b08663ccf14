"""The plain reference against the port at 120x160 on the CPU (the port's
kernels run their plain versions there), the control that has to fail, and
the Gauss-Newton work count on a hand-sized case."""

import numpy as np
import pytest
import torch

from benchmark import checks, harness, runners, reference, work
from small import small_cell

CPU = torch.device("cpu")


def _program(cell, seed):
    runner = runners.RUNNERS[cell.traffic["kind"]](cell.config, cell.traffic, seed, CPU)
    answers = harness.run_units(runner, CPU, count=1).answers
    return runner.inputs, answers[-1]


@pytest.mark.parametrize("name", ["tum_suite", "tum_pairs_b1024"])
def test_port_agrees_with_the_reference(name):
    cell = small_cell(name)
    inputs, answer = _program(cell, 20261018)
    check = checks.check(cell.traffic["kind"], cell.config, inputs, answer)
    assert set(check.gaps) == set(cell.limits)
    for number, gaps in check.gaps.items():
        assert np.all(gaps <= cell.limits[number]["limit"]), (number, gaps)
    assert all(int(e["evals"].min()) >= 1 for e in check.gn_log)


def test_reference_stereo_matches_the_port():
    """The reference's block matcher (kept for a later KITTI cell) against
    the port's `io.kitti.stereo_depth` on rendered stereo frames."""
    from vslam_tpu_torch.io.kitti import stereo_depth

    from benchmark import scenes

    cell = small_cell("kitti_suite", 188, 620, sequences=2, frames=3)
    cell.config["sensor"]["max_disparity"] = 48
    inputs = scenes.suite_inputs(cell.config, cell.traffic, 8, CPU)
    left, right = (x.float() for x in inputs.frame(2))
    prof = reference.profile(cell.config)
    fx = cell.config["sensor"]["fx"]
    ref = reference.stereo_depth(left, right, torch.full((2,), fx), prof)
    port = stereo_depth(left, right, fx, prof.baseline, max_disparity=prof.max_disparity)
    both = (ref > 0) & (port > 0)
    assert float(both.float().mean()) > 0.5  # the facade is matched over most of the image
    assert float(((ref > 0) != (port > 0)).float().mean()) < 1e-3
    assert torch.allclose(ref[both], port[both], rtol=1e-4)


def test_suite_reference_tracks_the_ground_truth():
    cell = small_cell("tum_suite")
    from benchmark import scenes

    inputs = scenes.suite_inputs(cell.config, cell.traffic, 4, CPU)
    R, t, log = checks.reference_suite(cell.config, inputs)
    gaps = checks.suite_gaps(inputs.poses.numpy(), R, t)
    assert gaps["pose_gap"].max() < 0.02 and gaps["step_gap"].max() < 0.01, gaps
    # one log entry a program launch: each step solves every level once
    assert len(log) == (cell.traffic["frames"] - 1) * cell.config["odometry"]["levels"]


def test_control_fails_the_pair_limit():
    """The reference in bfloat16 in the program's place reads above the
    limit, at 240x320 with 96 pairs (on the card, at the cell's size, its
    widest gap reads 0.52-1.96 over 3 seeds)."""
    cell = small_cell("tum_pairs_b1024", 240, 320, pairs=96)
    from benchmark import scenes

    inputs = scenes.pair_inputs(cell.config, cell.traffic, 5, CPU)
    R, t, _ = checks.reference_pairs(cell.config, inputs)
    Rc, tc, _ = checks.reference_pairs(cell.config, inputs, torch.bfloat16)
    assert checks.pose_gaps(checks.transforms(Rc, tc), R, t).max() > cell.limits["pose_gap"]["limit"]


def test_work_count_by_hand():
    # 2 pairs, F = 2 frames of P = 4 slots, a 3x5 image: pair 0 ran 3
    # iterations on 6 points, pair 1 one iteration on 1 point
    entry = {"frames": 2, "capacity": 4, "height": 3, "width": 5, "max_iterations": 10,
             "evals": torch.tensor([3, 1]), "points": torch.tensor([6, 1])}
    ops, nbytes = work.launch_work(entry)
    assert ops == (18 + 1) * 105
    taps = min(18 * 4, 15) * 2 + min(1 * 4, 15) * 2  # the image read at most once a pair
    per_pair = 2 * 4 * 41 + 2 * (48 + 28) + 16 + 4 * (64 + 20)
    assert nbytes == taps + 2 * per_pair
    assert work.least_seconds([entry, entry]) == pytest.approx(2 * max(ops / 67e12, nbytes / 3.35e12))
    merged = work.merge_blocks([[entry], [dict(entry, evals=torch.tensor([2]), points=torch.tensor([5]))]])
    assert merged[0]["evals"].tolist() == [3, 1, 2]


def test_se3_log_inverts_exp():
    xi = torch.tensor([[0.1, -0.2, 0.05, 0.02, -0.01, 0.03]], dtype=torch.float64)
    assert torch.allclose(reference.se3_log(reference.se3_exp(xi)), xi, atol=1e-12)
