"""Dataset IO and synthetic data (port of `vslam_tpu.io`: the synthetic
scenes, the TUM reader `io.tum`, the KITTI reader with stereo depth
`io.kitti`, the native PNG loader `io.native_loader`, the EXR codec
`io.exr` and the real-image fixtures `io.real_fixtures`)."""

from . import synthetic

__all__ = ["synthetic"]
