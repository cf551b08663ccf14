"""The comparison that decides a run's ``correct``.

Once the window has closed and the program's state is freed, the plain
reference (`reference.py`) tracks every sequence, or aligns every pair, of
the run's inputs again from the rendered sensor images, and each answer of
the program is held against it by a pose gap: ||log(T_ref^-1 T_prog)||,
metres and radians in one 6-vector, in float64. A pair's answer is its
relative pose, and its ``pose_gap`` that pose's gap. A suite's answer is a
sequence's trajectory, with two gaps: ``pose_gap``, the widest over its
frames' world-to-camera poses, and ``step_gap``, the widest over its
frame-to-frame motions T_k T_(k-1)^-1. A trajectory is a chain: a last-digit
difference (a summation order, a batch size) that moves one solve's stop by
an iteration moves every later pose, and on a drifting sequence that grows
to millimetres, while each step's motion stays within one solve's
tolerance; so the step gap is the tight number and the pose gap the loose
one. Each number compared is the run's widest, against the cell's limit for
it in `limits/<cell>.json`.

The reference's solves log the work that `work.py` counts.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import reference, scenes, work

__all__ = ["Check", "check", "pose_gaps", "steps", "transforms", "suite_gaps", "pair_gaps", "reference_suite",
           "reference_pairs", "RUNS", "GAPS"]

SUITE_BLOCK = 512  # sequences the reference tracks at once


class Check(NamedTuple):
    gaps: dict  # number compared -> its gap per answer (sequence or pair)
    gn_log: list  # one entry a launch of the program: its pairs' evaluated iterations and points


def pose_gaps(T_prog: np.ndarray, R_ref: torch.Tensor, t_ref: torch.Tensor) -> np.ndarray:
    """||log(T_ref^-1 T_prog)|| of (..., 4, 4) host transforms against the
    reference's (R (..., 3, 3), t (..., 3)), in float64."""
    Tp = torch.as_tensor(T_prog, dtype=torch.float64)
    ref = (R_ref.double().cpu(), t_ref.double().cpu())
    rel = reference.compose(reference.inverse(ref), (Tp[..., :3, :3], Tp[..., :3, 3]))
    return reference.se3_log(rel).norm(dim=-1).numpy()


def _cam(config: dict):
    s = config["sensor"]
    return s["fx"], s["fy"], s["cx"], s["cy"]


def reference_suite(config: dict, inputs: scenes.SuiteInputs, dtype: torch.dtype = torch.float32,
                    block: int = SUITE_BLOCK):
    """The reference's trajectories (R (S, F, 3, 3), t (S, F, 3)) of the
    suite's inputs, ``block`` sequences at a time, and its work log."""
    prof = reference.profile(config, dtype)
    S = inputs.first[0].shape[0]
    F = inputs.poses.shape[1]
    frames = [inputs.frame(k) for k in range(F)]
    Rs, ts, logs = [], [], []
    for i in range(0, S, block):
        j = min(i + block, S)
        images = torch.stack([f[0][i:j] for f in frames], 1)
        second = torch.stack([f[1][i:j] for f in frames], 1)
        log: list = []
        R, t = reference.run_suite(images, second, inputs.dt_ns / 1e9, _cam(config), prof, log)
        del images, second
        Rs.append(R.cpu())
        ts.append(t.cpu())
        logs.append(log)
    return torch.cat(Rs), torch.cat(ts), work.merge_blocks(logs)


def steps(T: np.ndarray) -> np.ndarray:
    """Frame-to-frame motions T_k T_(k-1)^-1 of (S, F, 4, 4) poses."""
    return np.einsum("sfij,sfjk->sfik", T[:, 1:], np.linalg.inv(T[:, :-1]))


def transforms(R: torch.Tensor, t: torch.Tensor) -> np.ndarray:
    T = np.zeros((*t.shape[:-1], 4, 4))
    T[..., :3, :3] = R.double().cpu().numpy()
    T[..., :3, 3] = t.double().cpu().numpy()
    T[..., 3, 3] = 1.0
    return T


def suite_gaps(poses: np.ndarray, R: torch.Tensor, t: torch.Tensor) -> dict:
    """Each sequence's widest pose gap and widest step gap."""
    ref_steps = steps(transforms(R, t))
    return {"pose_gap": pose_gaps(poses, R, t).max(axis=1),
            "step_gap": pose_gaps(steps(poses), torch.as_tensor(ref_steps[..., :3, :3]),
                                  torch.as_tensor(ref_steps[..., :3, 3])).max(axis=1)}


def reference_pairs(config: dict, inputs: scenes.PairInputs, dtype: torch.dtype = torch.float32):
    """The reference's relative poses (R (B, 3, 3), t (B, 3)) and its work log."""
    log: list = []
    R, t = reference.run_pairs(inputs.ref, inputs.cur, _cam(config), reference.profile(config, dtype), log)
    return R, t, log


def pair_gaps(poses: np.ndarray, R: torch.Tensor, t: torch.Tensor) -> dict:
    return {"pose_gap": pose_gaps(poses, R, t)}


RUNS = {"suite": reference_suite, "pairs": reference_pairs}
GAPS = {"suite": suite_gaps, "pairs": pair_gaps}


def check(kind: str, config: dict, inputs, answers: np.ndarray) -> Check:
    """The gaps of the program's answers of a ``kind`` of traffic: (S, F, 4,
    4) trajectories or (B, 4, 4) relative poses."""
    R, t, log = RUNS[kind](config, inputs)
    return Check(GAPS[kind](answers, R, t), log)
