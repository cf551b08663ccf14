"""Batched tracking (port of `vslam_tpu.parallel`): `align_pairs` and
`tracking_step` over B pairs, and `sequences`, S odometry sequences in
lock-step."""

from . import batched, sequences
from .batched import align_pairs, tracking_step
from .sequences import MultiSequenceOdometry

__all__ = ["batched", "sequences", "align_pairs", "tracking_step", "MultiSequenceOdometry"]
