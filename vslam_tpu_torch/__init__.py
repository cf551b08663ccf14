"""vslam_tpu_torch — the PyTorch / CUDA port of `vslam_tpu` for one NVIDIA H100.

The package mirrors the `vslam_tpu/` layout module for module. Plain tensor
code is PyTorch; the whole-level Gauss-Newton solve, a Pallas kernel in the
JAX package, is a hand-written CUDA kernel (`csrc/fused_solve.cu`) built with
nvcc at first use. The JAX package stays the reference: every ported function
is tested against the function it replaces. This package imports neither
`jax` nor `vslam_tpu`.
"""

__version__ = "0.1.0"

import torch as _torch

# Visual odometry is numerically sensitive: SE(3) compositions and the 6x6
# normal-equation reductions must run in full f32 (mirrors
# vslam_tpu/__init__.py, which forces "highest" matmul precision). TF32 keeps
# ~3 decimal digits, so it is off for matmuls and cuDNN alike.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from . import core

__all__ = ["core"]
