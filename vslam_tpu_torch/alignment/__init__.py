"""Direct image alignment (port of `vslam_tpu.alignment`)."""

from . import aligner, fused_solve, ic
from .aligner import RgbdAligner, stack_frames
from .ic import AlignmentConfig

__all__ = ["aligner", "fused_solve", "ic", "RgbdAligner", "stack_frames", "AlignmentConfig"]
