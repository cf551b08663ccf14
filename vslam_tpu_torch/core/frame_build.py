"""A frame's image pyramid from its sensor images, as one CUDA kernel a level.

`build_pyramid(intensity, depth, n_levels, depth_scale)` returns the four
per-level tuples of `core.frame.Frame` (intensity, depth, dIx, dIy) for
images of shape (..., H, W): intensity uint8 or float, depth int16 (the bits
of unsigned 16-bit counts, as `odometry.sequential._upload` sends them) or
float, metres = depth x ``depth_scale``. Level 0 is the widened intensity
and the scaled depth with non-finite values at 0; each level above is
cv::pyrDown of the intensity and the invalid-masked 3x3 median of the depth
on pyrDown's grid; dIx and dIy are Sobel of the 3x3 Gaussian blur.

* For CPU tensors it runs `build_pyramid_plain`, the chain of `core.image`
  stencils, any float dtype.
* For CUDA tensors it launches `csrc/frame_build.cu`, one launch a level
  (`FRAME_BUILD_LAUNCHES`), into one f32 buffer whose views are the planes,
  and counts the frames under "frame.kernel_frames" (`utils.timer`); it
  raises on inputs the kernel does not take (f32 or uint8 intensity, f32 or
  int16 depth, H and W at least 3 at every level a pyrDown reads, H W below
  2^31). The kernel equals the plain version bit for bit.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Tuple

import torch

from ..utils import timer
from . import image as img_ops

__all__ = ["build_pyramid", "build_pyramid_plain", "level_shapes", "sensor_f32", "FRAME_BUILD_LAUNCHES"]

# kernel launches made by build_pyramid (one a level on CUDA tensors)
FRAME_BUILD_LAUNCHES = 0

Levels = Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]


def sensor_f32(x: torch.Tensor) -> torch.Tensor:
    """Widen a sensor image to f32 on its device; int16 holds the bits of
    unsigned 16-bit depth counts (see `odometry.sequential._upload`)."""
    if x.dtype == torch.int16:
        return (x.to(torch.int32) & 0xFFFF).to(torch.float32)
    return x.to(torch.float32)


def level_shapes(H: int, W: int, n_levels: int) -> List[Tuple[int, int]]:
    """(H_l, W_l) of each level: ceil(n / 2) a level, as pyrDown."""
    shapes = [(H, W)]
    for _ in range(1, n_levels):
        h, w = shapes[-1]
        shapes.append(((h + 1) // 2, (w + 1) // 2))
    return shapes


def build_pyramid_plain(intensity: torch.Tensor, depth: torch.Tensor, n_levels: int,
                        depth_scale: float = 1.0) -> Levels:
    """The pyramid as plain PyTorch on the images' device: integer images
    widen as `sensor_f32`, float ones keep their dtype."""
    if not intensity.is_floating_point():
        intensity = sensor_f32(intensity)
    if not depth.is_floating_point():
        depth = sensor_f32(depth)
    if depth_scale != 1.0:
        depth = depth * depth_scale
    # non-finite depth -> 0 at ingest (reference NodeMapping.cpp createFrame)
    depth = torch.where(torch.isfinite(depth), depth, torch.zeros_like(depth))

    intensities = [intensity]
    depths = [depth]
    for _ in range(1, n_levels):
        intensities.append(img_ops.pyr_down(intensities[-1]))
        d_prev = depths[-1]
        d_blur = img_ops.median_blur_3x3_masked(d_prev, d_prev <= 0.0)
        # decimate on pyrDown's grid so odd sizes match the intensity levels
        depths.append(d_blur[..., ::2, ::2])

    dIx, dIy = [], []
    for lvl in range(n_levels):
        blurred = img_ops.gaussian_blur_3x3(intensities[lvl])
        dIx.append(img_ops.sobel_x(blurred))
        dIy.append(img_ops.sobel_y(blurred))
    return intensities, depths, dIx, dIy


def _check(intensity: torch.Tensor, depth: torch.Tensor, n_levels: int) -> List[Tuple[int, int]]:
    """The kernel's conditions on its inputs, before any device is asked;
    returns the level shapes."""
    if intensity.dim() < 2 or tuple(depth.shape) != tuple(intensity.shape):
        raise ValueError(f"intensity and depth: expected one shape (..., H, W), got "
                         f"{tuple(intensity.shape)} and {tuple(depth.shape)}")
    if intensity.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"intensity: expected uint8 or float32, got {intensity.dtype}")
    if depth.dtype not in (torch.int16, torch.float32):
        raise ValueError(f"depth: expected int16 (unsigned counts) or float32, got {depth.dtype}")
    if n_levels < 1:
        raise ValueError(f"n_levels: expected at least 1, got {n_levels}")
    H, W = intensity.shape[-2:]
    if H * W >= 2**31:
        raise ValueError(f"image of {H}x{W} = {H * W} pixels: the kernel takes fewer than 2^31")
    shapes = level_shapes(H, W, n_levels)
    # the 3x3 stencils' and pyrDown's reflect-101 borders need 3 pixels
    for lvl, (h, w) in enumerate(shapes[:max(1, n_levels - 1)]):
        if h < 3 or w < 3:
            raise ValueError(f"level {lvl} of {n_levels} is {h}x{w}: the pyramid needs H and W of "
                             f"at least 3 at every level it reads")
    return shapes


def _launch(intensity: torch.Tensor, depth: torch.Tensor, n_levels: int, depth_scale: float = 1.0,
            lib=None) -> Levels:
    """The kernel's launches; ``lib`` another build's C entries (for
    measurements), by default the package's."""
    global FRAME_BUILD_LAUNCHES
    shapes = _check(intensity, depth, n_levels)
    for name, x in (("intensity", intensity), ("depth", depth)):
        if not x.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    if depth.device != intensity.device:
        raise ValueError(f"depth on {depth.device}, intensity on {intensity.device}")
    from .._build import library

    batch = intensity.shape[:-2]
    B = math.prod(batch)
    sizes = [B * h * w for h, w in shapes]
    out = torch.empty(4 * sum(sizes), dtype=torch.float32, device=intensity.device)
    if B > 0:
        with torch.cuda.device(intensity.device):
            stream = torch.cuda.current_stream(intensity.device).cuda_stream
            err = (lib or library()).vslam_frame_build(
                ctypes.c_void_p(intensity.data_ptr()), ctypes.c_void_p(depth.data_ptr()),
                ctypes.c_int(intensity.dtype == torch.uint8), ctypes.c_int(depth.dtype == torch.int16),
                ctypes.c_float(depth_scale), *(ctypes.c_int(x) for x in (B, *shapes[0], n_levels)),
                ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"frame_build kernel launch failed: CUDA error {err}")
        FRAME_BUILD_LAUNCHES += n_levels
        timer.count("frame.kernel_frames", B)
    planes: Levels = ([], [], [], [])
    at = 0
    for (h, w), n in zip(shapes, sizes):
        for p in range(4):
            planes[p].append(out[at:at + n].view(*batch, h, w))
            at += n
    return planes


def build_pyramid(intensity: torch.Tensor, depth: torch.Tensor, n_levels: int,
                  depth_scale: float = 1.0) -> Levels:
    """(intensities, depths, dIx, dIy), one tensor a level each: the
    plain version for CPU tensors, else the kernel."""
    if intensity.device.type == "cpu":
        return build_pyramid_plain(intensity, depth, n_levels, depth_scale)
    return _launch(intensity.contiguous(), depth.contiguous(), n_levels, depth_scale)
