"""A run with its timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
(`harness.run_cell`) on the CPU at a small size, with one fault planted in
the program: a step that returns its state unchanged, half of the batch left
out, an answer altered where it is produced. A sound run at the same size
comes out correct. (A cell on one chip has no exchange between chips.)"""

import io
import json
import time

import pytest
import torch

from benchmark import harness
from small import small_cell

CPU = torch.device("cpu")


def _result(cell, seed=77):
    buf = io.StringIO()
    assert harness.run_cell(cell, seed, 0.0, False, CPU, time.perf_counter(), out=buf) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["tum_suite", "tum_pairs_b1024"])
def test_sound_run_is_correct(name):
    r = _result(small_cell(name))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


def test_step_returning_its_state_unchanged(monkeypatch):
    from vslam_tpu_torch.odometry import sequential

    real = sequential._step

    def frozen(state, *args):
        _, out = real(state, *args)
        return state, (state.pose_last,) + out[1:]

    monkeypatch.setattr(sequential, "_step", frozen)
    # a second of motion, as a cell's 32 frames have
    assert not _result(small_cell("tum_suite", frames=32, chunk=16))["correct"]


def test_half_the_suite_left_out(monkeypatch):
    from vslam_tpu_torch.parallel import sequences

    real = sequences.scan_sequences

    def half(states, intensity, depth, dt, live, cameras, cfg):
        S = intensity.shape[0]
        live = torch.ones(intensity.shape[:2], dtype=torch.bool, device=intensity.device)
        live[S // 2:] = False  # the second half never advances
        return real(states, intensity, depth, dt, live, cameras, cfg)

    monkeypatch.setattr(sequences, "scan_sequences", half)
    assert not _result(small_cell("tum_suite", frames=32, chunk=16))["correct"]


def test_half_the_pairs_left_out(monkeypatch):
    from vslam_tpu_torch.core.se3 import SE3
    from vslam_tpu_torch.parallel import batched

    real = batched.align_pairs

    def half(ref, cur, rel_init, x_pred, cfg):
        rel, cov, valid = real(ref, cur, rel_init, x_pred, cfg)
        B = rel.t.shape[0]
        R, t = rel.R.clone(), rel.t.clone()
        R[B // 2:], t[B // 2:] = rel_init.R[B // 2:], rel_init.t[B // 2:]
        return SE3(R, t), cov, valid

    monkeypatch.setattr(batched, "align_pairs", half)
    assert not _result(small_cell("tum_pairs_b1024", pairs=16))["correct"]


def test_one_answer_altered(monkeypatch):
    from vslam_tpu_torch.core.se3 import SE3
    from vslam_tpu_torch.parallel import batched

    real = batched.align_pairs

    def altered(*args):
        rel, cov, valid = real(*args)
        t = rel.t.clone()
        t[0, 0] += 0.01  # one pair's answer moved by a centimetre
        return SE3(rel.R, t), cov, valid

    monkeypatch.setattr(batched, "align_pairs", altered)
    assert not _result(small_cell("tum_pairs_b1024"))["correct"]


def test_one_pose_altered_in_a_suite(monkeypatch):
    from vslam_tpu_torch.parallel import sequences

    real = sequences.MultiSequenceOdometry._collect

    def altered(out, stamps, poses, cov, is_kf=None):
        poses.t[0, -1, 2] += 0.02  # the last frame of the chunk of sequence 0, by 2 cm
        return real(out, stamps, poses, cov, is_kf)

    monkeypatch.setattr(sequences.MultiSequenceOdometry, "_collect", staticmethod(altered))
    assert not _result(small_cell("tum_suite"))["correct"]
