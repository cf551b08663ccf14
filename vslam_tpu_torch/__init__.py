"""vslam_tpu_torch — the PyTorch / CUDA port of `vslam_tpu` for one NVIDIA H100.

The package mirrors the `vslam_tpu/` layout module for module. Plain tensor
code is PyTorch; each Pallas kernel of the JAX package is a hand-written
CUDA kernel in one of three sources, built with nvcc at first use:
`csrc/fused_solve.cu` (the whole-level Gauss-Newton solve, quadratic and
robust entries), `csrc/fused_ne.cu` (the per-iteration sampler and normal
equations) and `csrc/sample_mxu.cu` (the `mxu` sampler); a fourth,
`csrc/frame_build.cu`, builds a frame's pyramid on the card, where the JAX
package leaves it to XLA. The JAX package
stays the reference: every ported function is tested against the function
it replaces. This package imports neither `jax` nor `vslam_tpu`.

The entry points run on CUDA unless the caller names another device: the
sequential scan (`odometry.sequential.SequentialOdometry`, with stereo depth
from `io.kitti` when given a baseline), suite mode
(`parallel.sequences.MultiSequenceOdometry`), the per-frame pipeline
(`odometry.pipeline.OdometryPipeline`), the KITTI reader
(`io.kitti.KittiDataset`), the secondary aligners (`alignment.fa_se3.
RgbdAlignerFa`, `alignment.icp.IcpAligner`), the mapping backend
(`odometry.sequential_mapping.ChunkMappingBackend`: features on the card,
matching, BA and the pose graph on the CPU beside the scan by default),
`io.synthetic.render_boxes_batch` and the evaluation CLI,
`python -m vslam_tpu_torch.eval.evaluate` (``--device``). The live viewer
(`viz.LiveViz`) and checkpoint / resume (`utils.checkpoint`) hang off the
scan, the pipeline and the CLI.
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
