"""Batched tracking (port of `vslam_tpu.parallel`; `align_pairs` and
`tracking_step` so far)."""

from . import batched
from .batched import align_pairs, tracking_step

__all__ = ["batched", "align_pairs", "tracking_step"]
