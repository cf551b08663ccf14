"""Core geometry and image numerics (port of `vslam_tpu.core`)."""

from . import camera, frame, image, lie_np, pose_cov, se3
from .camera import Camera
from .frame import Frame, create_frame, frame_pcl
from .se3 import SE3

__all__ = ["camera", "frame", "image", "lie_np", "pose_cov", "se3", "Camera", "Frame", "SE3", "create_frame",
           "frame_pcl"]
