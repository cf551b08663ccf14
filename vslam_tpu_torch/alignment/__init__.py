"""Direct image alignment (port of `vslam_tpu.alignment`)."""

from . import aligner, fused_ne, fused_solve, ic, pallas_kernels
from .aligner import RgbdAligner, stack_frames
from .ic import AlignmentConfig

__all__ = ["aligner", "fused_ne", "fused_solve", "ic", "pallas_kernels", "RgbdAligner", "stack_frames", "AlignmentConfig"]
