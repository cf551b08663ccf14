"""The least time the Gauss-Newton kernel's work needs on the card.

The work is counted from the inputs and from the plain reference's solves
(`reference.solve_level`'s log), never from counters of the program: for
each pair (a suite's sequence-step, or an aligned pair), level and
evaluated Gauss-Newton iteration, every interest point is warped,
projected, sampled bilinearly and accumulated into JᵀJ, Jᵀr and chi2; each
input byte is read once and each output byte written once. So a later
program that takes fewer iterations, or that drops a kernel, is measured
against the same work. The arithmetic is `chip_smoke._bound` and
`_solve_work`'s, with the image's taps capped per pair.
"""

from __future__ import annotations

from typing import Iterable

import torch

__all__ = ["PEAK_F32_OPS", "PEAK_BYTES", "OPS_PER_POINT", "launch_work", "least_seconds", "merge_blocks"]

# NVIDIA H100 SXM, published: f32 outside the tensor cores, HBM3 bandwidth
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# f32 operations a point and iteration: warp and projection (32), the
# bilinear sample (15), the Gram row of J, r and r^2 (58)
OPS_PER_POINT = 32 + 15 + 58
TAPS = 4  # pixels a bilinear sample reads


def launch_work(entry: dict, image_bytes: int = 2):
    """(operations, bytes) of one level solve of N pairs, from one
    `reference.solve_level` log entry. Bytes a pair: its F frames' level
    data (points 12, mask 1, steepest-descent row 24, template 4 bytes a
    point slot), pose 48 and prior 28 bytes a frame, the camera 16, the
    image taps it reads (at most its whole image, ``image_bytes`` a
    pixel), the result row and the two iteration histories (4 bytes each)."""
    evals = entry["evals"].double()
    points = entry["points"].double()
    F, P = entry["frames"], entry["capacity"]
    point_evals = evals * points
    ops = float(point_evals.sum()) * OPS_PER_POINT
    taps = point_evals.mul(TAPS).clamp(max=entry["height"] * entry["width"]) * image_bytes
    per_pair = F * P * 41 + F * (48 + 28) + 16 + 4 * (64 + 2 * entry["max_iterations"])
    nbytes = float(taps.sum()) + per_pair * len(evals)
    return ops, nbytes


def merge_blocks(blocks) -> list:
    """One log from the logs of blocks of pairs run one after another (the
    same launches in the same order in each block): entry i of every block
    is one launch of the program, which solves all the pairs at once."""
    blocks = list(blocks)
    if any(len(b) != len(blocks[0]) for b in blocks):
        raise ValueError("the blocks' logs differ in their launches")
    return [dict(parts[0], evals=torch.cat([p["evals"] for p in parts]),
                 points=torch.cat([p["points"] for p in parts])) for parts in zip(*blocks)]


def least_seconds(log: Iterable[dict], image_bytes: int = 2) -> float:
    """The least time of a sequence of launches: each launch's larger of
    operations over the f32 peak and bytes over the bandwidth, summed."""
    total = 0.0
    for entry in log:
        ops, nbytes = launch_work(entry, image_bytes)
        total += max(ops / PEAK_F32_OPS, nbytes / PEAK_BYTES)
    return total
