"""Direct image alignment (port of `vslam_tpu.alignment`): the
inverse-compositional SE(3) aligner and its kernels, and the secondary
aligners (forward-additive SE(3), dense ICP, 2-D Lucas-Kanade)."""

from . import aligner, fa_se3, fused_ne, fused_solve, ic, icp, lk2d, pallas_kernels
from .aligner import RgbdAligner, stack_frames
from .fa_se3 import FaAlignmentConfig, RgbdAlignerFa
from .ic import AlignmentConfig
from .icp import IcpAligner, IcpConfig

__all__ = ["aligner", "fa_se3", "fused_ne", "fused_solve", "ic", "icp", "lk2d", "pallas_kernels", "RgbdAligner",
           "stack_frames", "AlignmentConfig", "FaAlignmentConfig", "RgbdAlignerFa", "IcpAligner", "IcpConfig"]
