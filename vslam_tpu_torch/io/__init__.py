"""Synthetic data (port of `vslam_tpu.io`; the dataset loaders come later)."""

from . import synthetic

__all__ = ["synthetic"]
