"""Batched tracking (port of `vslam_tpu.parallel`; `align_pairs` so far)."""

from . import batched
from .batched import align_pairs

__all__ = ["batched", "align_pairs"]
