"""Batched and sharded tracking (port of `vslam_tpu.parallel`): `align_pairs`
and `tracking_step` over B pairs, `sequences`, S odometry sequences in
lock-step, and their sharding over GPUs, one process a card on
`torch.distributed` (`make_mesh`, `shard_batch`, `sharded_tracking_step`,
`multihost`)."""

from . import batched, multihost, sequences
from .batched import align_pairs, make_mesh, shard_batch, sharded_tracking_step, tracking_step
from .sequences import MultiSequenceOdometry

__all__ = [
    "batched",
    "multihost",
    "sequences",
    "align_pairs",
    "make_mesh",
    "shard_batch",
    "sharded_tracking_step",
    "tracking_step",
    "MultiSequenceOdometry",
]
