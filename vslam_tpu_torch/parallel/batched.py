"""Batched and sharded frame-pair tracking — the throughput path (port of
`vslam_tpu.parallel.batched`).

The JAX package aligns B independent pairs with `vmap`; here B is the
leading axis of every tensor and one `ic.align` call serves the batch, so
the whole-level GN kernel runs once per pyramid level for all B pairs.
`tracking_step` adds a per-pair EKF around it.

Across GPUs the port runs one process a card (a rank; `multihost.
initialize`), and `make_mesh` lays the ranks on a 1-D `DeviceMesh`.
`shard_batch` gives each rank its block of the batch, and
`sharded_tracking_step` solves the block's pairs on the rank's card; one
`all_reduce` of the pair (converged, pairs) gives every rank the global
converged fraction:

    multihost.initialize()  # in each process torchrun starts
    mesh = make_mesh()
    step = sharded_tracking_step(mesh, cfg)
    ekf, rel, valid, frac = step(*shard_batch((ekf, ref, cur, dt), mesh))
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..alignment import ic
from ..alignment.ic import AlignmentConfig
from ..core import se3
from ..core.frame import Frame
from ..core.se3 import SE3
from ..kalman import ekf_se3
from ..utils.tree import tree_map
from . import mesh as mesh_lib

__all__ = ["align_pairs", "tracking_step", "make_mesh", "shard_batch", "sharded_tracking_step"]


def align_pairs(
    ref: Frame,  # leaves batched (B, ...)
    cur: Frame,  # leaves batched (B, ...)
    rel_init: SE3,  # (B, 3, 3), (B, 3)
    x_pred: Optional[torch.Tensor],  # (B, 6) prior means, or None (zeros)
    cfg: AlignmentConfig,
) -> Tuple[SE3, torch.Tensor, torch.Tensor]:
    """Coarse-to-fine alignment of B independent pairs, each against its
    one reference frame. Returns (rel (B,), cov (B, 6, 6), valid (B,)).
    As in the JAX function, a missing x_pred becomes zeros, so the prior
    (when cfg.include_prior) pulls toward zero motion."""
    if x_pred is None:
        x_pred = rel_init.t.new_zeros(rel_init.t.shape[0], 6)
    ref_f = tree_map(lambda x: x[:, None], ref)  # frame axis F = 1
    rel, cov, valid = ic.align(
        ref_f, cur, SE3(rel_init.R[:, None], rel_init.t[:, None]), x_pred[:, None], cfg
    )
    return SE3(rel.R[:, 0], rel.t[:, 0]), cov, valid


def tracking_step(
    ekf: ekf_se3.EkfState,  # per-pair filters, leaves (B, ...)
    ref: Frame,
    cur: Frame,
    dt: torch.Tensor,  # (B,) seconds
    cfg: AlignmentConfig,
) -> Tuple[ekf_se3.EkfState, SE3, torch.Tensor]:
    """One tracking step for B sequences: EKF predict, alignment with the
    predicted relative motion exp(v dt) as init and prior mean, then the
    velocity update log(rel) / dt with the aligner's covariance structure as
    measurement noise, kept only where the alignment is valid. Returns
    (ekf, rel (B,), valid (B,))."""
    ekf_pred, _ = ekf_se3.predict(ekf, dt)
    rel_pred = se3.exp(ekf.velocity * dt[:, None])
    rel, cov, valid = align_pairs(ref, cur, rel_pred, se3.log(rel_pred), cfg)
    v_meas = se3.log(rel) / torch.clamp(dt, min=1e-6)[:, None]
    R = ekf_se3.measurement_noise_from_cov(cov, scale=1e-2)
    new = ekf_se3.update(ekf_pred, v_meas, R)
    ekf_new = tree_map(
        lambda a, b: torch.where(valid.view(-1, *([1] * (a.dim() - 1))), a, b), new, ekf_pred
    )
    return ekf_new, rel, valid


# ---------------------------------------------------------------------------
# Several GPUs: one rank a card
# ---------------------------------------------------------------------------


def make_mesh(devices=None, axis: str = "data", device=None):
    """A 1-D `DeviceMesh` named ``(axis,)`` over every rank of the process
    group, or over the ranks listed in ``devices`` (every rank calls it,
    in the listed ranks' mesh order). ``device`` names the ranks' device
    type: CUDA when None (raising without CUDA), "cpu" for gloo groups."""
    from torch.distributed.device_mesh import DeviceMesh

    device_type = mesh_lib.rank_device(device).type
    mesh_lib.require_group("make_mesh")
    ranks = list(range(torch.distributed.get_world_size())) if devices is None else [int(r) for r in devices]
    return DeviceMesh(device_type, ranks, mesh_dim_names=(axis,))


def shard_batch(tree, mesh, axis: str = "data"):
    """This rank's block of a batched tree that every rank holds whole:
    block i of the leading axis for the rank at coordinate i of ``axis``,
    on the rank's device; 0-dim leaves are replicated. A leading axis that
    the axis size does not divide raises."""
    index, count = mesh_lib.axis_index(mesh, axis), mesh_lib.axis_size(mesh, axis)
    device = mesh_lib.mesh_device(mesh)
    return tree_map(lambda x: mesh_lib.block(x, index, count, device), tree)


def sharded_tracking_step(mesh, cfg: AlignmentConfig, axis: str = "data"):
    """The tracking step over a batch sharded on ``axis``: a callable
    ``(ekf, ref, cur, dt)`` on this rank's blocks returning ``(ekf, rel,
    valid, frac)``. The per-pair solves are the rank's own (`tracking_step`
    on its block); ``frac``, the converged fraction of the whole batch, is
    one `all_reduce` of (converged, pairs) and the same on every rank."""
    return _sharded_step(mesh, cfg, (axis,))


def _sharded_step(mesh, cfg: AlignmentConfig, axes):
    """`tracking_step` on this rank's block; ``frac`` reduced over ``axes``
    in order (`multihost.sharded_tracking_step_2d` passes two)."""
    for axis in axes:
        mesh_lib.axis_index(mesh, axis)  # this rank must be on the mesh

    def step(ekf, ref, cur, dt):
        ekf_new, rel, valid = tracking_step(ekf, ref, cur, dt, cfg)
        return ekf_new, rel, valid, mesh_lib.global_fraction(valid.sum(), valid.shape[0], mesh, axes)

    return step
