"""The generators: a seed gives the same inputs, another seed others."""

import torch

from benchmark import scenes
from small import small_cell

CPU = torch.device("cpu")


def _suite(seed, name="tum_suite"):
    cell = small_cell(name)
    return scenes.suite_inputs(cell.config, cell.traffic, seed, CPU)


def test_suite_repeats_per_seed_and_differs_across_seeds():
    a, b, c = _suite(2**40 + 7), _suite(2**40 + 7), _suite(5)
    for k in range(6):
        assert all(torch.equal(x, y) for x, y in zip(a.frame(k), b.frame(k)))
    assert torch.equal(a.poses, b.poses)
    assert not torch.equal(a.frame(3)[0], c.frame(3)[0])
    assert not torch.equal(a.poses, c.poses)


def test_suite_inputs_are_sensor_frames():
    s = _suite(11)
    i, d = s.frame(0)
    assert i.dtype == torch.uint8 and d.dtype == torch.int16
    metres = (d.to(torch.int32) & 0xFFFF).float() * 0.0002
    assert 1.0 < float(metres[metres > 0].median()) < 4.0  # the plane ~2 m ahead
    assert float(i.float().std()) > 10.0  # textured
    assert torch.allclose(s.poses[:, 0], torch.eye(4, dtype=torch.float64).expand(3, 4, 4))
    # every sequence has its own scene and motion
    assert not torch.equal(s.frame(2)[0][0], s.frame(2)[0][1])


def test_stereo_suite_has_a_right_image():
    s = _suite(3, "kitti_suite")
    left, right = s.frame(1)
    assert left.dtype == right.dtype == torch.uint8 and not torch.equal(left, right)


def test_pairs_repeat_per_seed_and_follow_the_motion_bounds():
    cell = small_cell("tum_pairs_b1024", pairs=16)
    a = scenes.pair_inputs(cell.config, cell.traffic, 99, CPU)
    b = scenes.pair_inputs(cell.config, cell.traffic, 99, CPU)
    c = scenes.pair_inputs(cell.config, cell.traffic, 100, CPU)
    assert torch.equal(a.xis, b.xis) and torch.equal(a.cur[0], b.cur[0])
    assert not torch.equal(a.xis, c.xis)
    assert float(a.xis[:, :3].abs().max()) <= 0.01 and float(a.xis[:, 3:].abs().max()) <= 0.005
