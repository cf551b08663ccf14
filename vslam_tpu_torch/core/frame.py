"""Frame: the per-image pyramid as a NamedTuple of tensors.

Port of `vslam_tpu.core.frame`. Level 0 is the full resolution. Intensity
levels come from repeated pyrDown; depth levels from the invalid-masked 3x3
median then decimation on pyrDown's grid; derivatives are Sobel of the 3x3
Gaussian-blurred intensity (`Frame.cpp:215-275`). `frame_build` computes
the levels: a CUDA kernel on the card, the plain `core.image` stencils on
the CPU.

Every leaf may carry leading batch axes: a frame built from (B, H, W)
images has (B,)-shaped camera leaves and a (B,) identity pose, so a batch of
pairs is one Frame (the port's explicit pair axis in place of `vmap`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import camera as cam_mod
from . import frame_build
from . import se3
from .camera import Camera
from .se3 import SE3

__all__ = ["Frame", "create_frame", "frame_pcl", "num_levels", "sensor_to_f32"]


def sensor_to_f32(intensity: torch.Tensor, depth: torch.Tensor, depth_scale: float = 1.0):
    """Native sensor dtype -> (f32 intensity, metric f32 depth): uint8 gray
    and uint16 depth counts (times ``depth_scale`` metres per count) convert;
    float inputs pass through unchanged."""
    if not intensity.is_floating_point():
        intensity = intensity.to(torch.float32)
    if not depth.is_floating_point():
        depth = depth.to(torch.float32) * depth_scale
    return intensity, depth


class Frame(NamedTuple):
    intensity: Tuple[torch.Tensor, ...]  # (..., H_l, W_l) float, [0, 255]
    depth: Tuple[torch.Tensor, ...]  # (..., H_l, W_l) metres; <= 0 invalid
    dIx: Tuple[torch.Tensor, ...]  # Sobel-x of blurred intensity
    dIy: Tuple[torch.Tensor, ...]
    cameras: Tuple[Camera, ...]  # leaves (...,)
    pose: SE3  # world -> camera, leaves (..., 3, 3), (..., 3)

    @property
    def n_levels(self) -> int:
        return len(self.intensity)

    def width(self, level: int = 0) -> int:
        return self.intensity[level].shape[-1]

    def height(self, level: int = 0) -> int:
        return self.intensity[level].shape[-2]


def num_levels(frame: Frame) -> int:
    return len(frame.intensity)


def create_frame(
    intensity: torch.Tensor,
    depth: torch.Tensor,
    camera: Camera,
    n_levels: int = 3,
    pose: Optional[SE3] = None,
    depth_scale: float = 1.0,
) -> Frame:
    """Build the pyramid frame from full-resolution intensity + depth
    (..., H, W): float images, or sensor images (uint8 intensity, int16 bits
    of unsigned depth counts) that widen as they are read; metres = depth x
    ``depth_scale``. Level scale is 0.5 per level. Camera leaves are
    broadcast to the images' batch shape. On CUDA the levels are one kernel
    launch each (`frame_build`), on the CPU the plain stencils."""
    # the pyramid first: on the card its kernels then run while the host
    # makes the small camera and pose leaves behind them
    intensities, depths, dIx, dIy = frame_build.build_pyramid(intensity, depth, n_levels, depth_scale)
    batch = intensity.shape[:-2]
    device = intensity.device
    dtype = intensity.dtype if intensity.is_floating_point() else torch.float32
    if pose is None:
        pose = se3.identity(batch, dtype=dtype, device=device)
    camera = Camera(
        *(torch.as_tensor(c, dtype=dtype, device=device).expand(batch).clone() for c in camera)
    )
    cams = [camera] + [cam_mod.scale(camera, 0.5**lvl) for lvl in range(1, n_levels)]
    return Frame(
        intensity=tuple(intensities),
        depth=tuple(depths),
        dIx=tuple(dIx),
        dIy=tuple(dIy),
        cameras=tuple(cams),
        pose=pose,
    )


def frame_pcl(frame: Frame, level: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense camera-frame point cloud of a pyramid level: (points (..., H,
    W, 3), valid (..., H, W)); invalid pixels get the zero point, as
    reference `Frame::computePcl` (`Frame.cpp:233-253`)."""
    d = frame.depth[level]
    H, W = d.shape[-2:]
    valid = torch.isfinite(d) & (d > 0.0)
    ys = torch.arange(H, dtype=d.dtype, device=d.device)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=d.dtype, device=d.device)[None, :].expand(H, W)
    uv = torch.stack([xs, ys], dim=-1).expand(*d.shape, 2)
    cam = cam_mod.expand(frame.cameras[level], d.dim())
    pts = cam_mod.backproject(cam, uv, torch.where(valid, d, torch.zeros_like(d)))
    return torch.where(valid[..., None], pts, torch.zeros_like(pts)), valid
