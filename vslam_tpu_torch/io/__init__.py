"""Dataset IO and synthetic data (port of `vslam_tpu.io`: the synthetic
scenes, the TUM reader `io.tum`, the KITTI reader with stereo depth
`io.kitti` and the native PNG loader `io.native_loader`)."""

from . import synthetic

__all__ = ["synthetic"]
