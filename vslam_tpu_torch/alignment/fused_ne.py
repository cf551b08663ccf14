"""The per-iteration residual pass at one pose as CUDA kernels.

Ports of the JAX package's `fused_ne.fused_level_sample` (Pallas kernel
`_sample_level_kernel`) and `fused_ne.fused_level_ne` (`_ne_kernel`), the
`fused` sampler of `ic.level_normal_equations`; the kernels are
`csrc/fused_ne.cu`. Both take the level data of B pairs x F stacked frames
as `precompute_level` lays it out, with no packing:

    data   ICLevelData leaves (B, F, P, ...)
    rel    SE3 (B, F): the pose of every stacked frame
    image  (B, H, W) float32 or bfloat16: the current image of each pair
    cam    Camera leaves (B,)

* `fused_level_sample` -> (iwxp (B, F, P) f32, visible (B, F, P) bool):
  warp, projection, visibility and the nearest or bilinear sample; an
  invisible point samples pixel (0, 0), so every entry is defined.
* `fused_level_ne` -> (A (B, F, 6, 6) symmetric, b (B, F, 6), chi2 (B, F),
  n_visible (B, F)): the raw, unnormalized normal equations with weight 1
  on the visible points (the quadratic loss) and r = iwxp - templ.

Each has a plain PyTorch twin (`*_plain`), on any device: the CPU path, and
the oracle the kernel is held against bit for bit on the card (the NE sums
run in the kernel's order, `fused_solve._block_sum(ctas=ne_ctas(P))`: a
cluster of `NE_CTAS` blocks per (pair, frame) above `NE_CLUSTER_POINTS`
points, else one block). The wrappers take the twin
for CPU tensors and, for any other device, launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.camera import Camera
from ..core.se3 import SE3
from ..solvers.loss import LossConfig
from .fused_solve import _checked, _frame_sums, _gram_matrix, _sample

__all__ = [
    "fused_level_sample",
    "fused_level_sample_plain",
    "fused_level_ne",
    "fused_level_ne_plain",
    "SAMPLE_LAUNCHES",
    "NE_LAUNCHES",
    "NE_CTAS",
    "NE_CLUSTER_POINTS",
    "ne_ctas",
]

# kernel launches made by the wrappers (one per call on CUDA tensors)
SAMPLE_LAUNCHES = 0
NE_LAUNCHES = 0

# thread blocks per (pair, frame) of the NE kernel (csrc/fused_ne.cu kNeCtas,
# one cluster) for frames of more than NE_CLUSTER_POINTS points
# (kNeClusterPoints), one block for smaller ones: fix its sum order
NE_CTAS = 2
NE_CLUSTER_POINTS = 1024

_QUADRATIC = LossConfig("None")
_NE_OUT = 44  # csrc/fused_ne.cu kNeOut: A (36), b (6), chi2, n_visible


def fused_level_sample_plain(data, rel: SE3, image: torch.Tensor, cam: Camera, interpolation="bilinear"):
    """The plain version of `fused_level_sample`, on any device."""
    return _sample(data, rel, image, cam, interpolation == "bilinear")


def ne_ctas(P: int) -> int:
    """The NE kernel's blocks per (pair, frame) for frames of P points."""
    return NE_CTAS if P > NE_CLUSTER_POINTS else 1


def fused_level_ne_plain(data, rel: SE3, image: torch.Tensor, cam: Camera, interpolation="bilinear", *,
                         ctas: int | None = None):
    """The plain version of `fused_level_ne`, on any device. ``ctas`` is the
    kernel's blocks per (pair, frame), which fixes its sum order; by default
    the kernel's own, `ne_ctas(P)`."""
    ctas = ne_ctas(data.mask.shape[-1]) if ctas is None else ctas
    sums = _frame_sums(data, rel, image, cam, interpolation == "bilinear", _QUADRATIC, ctas)
    return _gram_matrix(sums), sums[..., 21:27], sums[..., 27], sums[..., 28]


def _level_args(data, rel: SE3, image: torch.Tensor, cam: Camera, with_ne: bool):
    """Validated tensors and sizes shared by both C entries. The caller
    holds the tensors until the launch returns: the camera rows and a
    contiguous image copy are made here, and freed memory may be handed to
    the next allocation."""
    B, F, P = data.mask.shape
    H, W = image.shape[-2:]
    f32 = torch.float32
    if image.dtype not in (f32, torch.bfloat16):
        raise ValueError(f"image: expected float32 or bfloat16, got {image.dtype}")
    image = image.contiguous()  # a pyramid level may be a strided view
    if min(B, F, P) < 1 or min(H, W) < 2:
        raise ValueError(f"empty problem: B={B} F={F} P={P} H={H} W={W}")
    cam_t = torch.stack([c.reshape(B) for c in cam], dim=1).to(f32).contiguous()
    tensors = [_checked("pcl", data.pcl, (B, F, P, 3), f32)]
    if with_ne:
        tensors += [_checked("J", data.J, (B, F, P, 6), f32),
                    _checked("templ", data.templ, (B, F, P), f32)]
    tensors += [
        _checked("mask", data.mask, (B, F, P), torch.bool),
        _checked("rel.R", rel.R, (B, F, 3, 3), f32),
        _checked("rel.t", rel.t, (B, F, 3), f32),
        _checked("cam", cam_t, (B, 4), f32),
        _checked("image", image, (B, H, W), image.dtype),
    ]
    sizes = [ctypes.c_int(x) for x in (int(image.dtype == torch.bfloat16), B, F, P, H, W)]
    return tensors, sizes, (B, F, P)


def _ptrs(tensors):
    return [ctypes.c_void_p(t.data_ptr()) for t in tensors]


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _launch_sample(data, rel: SE3, image: torch.Tensor, cam: Camera, interpolation, lib=None):
    """The sample kernel's launch; ``lib`` another build's C entries (a
    design variant or an earlier version, for measurements), by default the
    package's."""
    global SAMPLE_LAUNCHES
    from .._build import library

    tensors, sizes, (B, F, P) = _level_args(data, rel, image, cam, with_ne=False)
    dev = data.pcl.device
    iwxp = torch.empty(B, F, P, dtype=torch.float32, device=dev)
    visible = torch.empty(B, F, P, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        err = (lib or library()).vslam_fused_level_sample(
            *_ptrs(tensors), *sizes, ctypes.c_int(int(interpolation == "bilinear")),
            ctypes.c_void_p(iwxp.data_ptr()), ctypes.c_void_p(visible.data_ptr()), _stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_level_sample kernel launch failed: CUDA error {err}")
    SAMPLE_LAUNCHES += 1
    return iwxp, visible


def _launch_ne(data, rel: SE3, image: torch.Tensor, cam: Camera, interpolation, lib=None):
    """The NE kernel's launch; ``lib`` as for `_launch_sample`."""
    global NE_LAUNCHES
    from .._build import library

    tensors, sizes, (B, F, P) = _level_args(data, rel, image, cam, with_ne=True)
    dev = data.pcl.device
    out = torch.empty(B, F, _NE_OUT, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = (lib or library()).vslam_fused_level_ne(
            *_ptrs(tensors), *sizes, ctypes.c_int(int(interpolation == "bilinear")),
            ctypes.c_void_p(out.data_ptr()), _stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_level_ne kernel launch failed: CUDA error {err}")
    NE_LAUNCHES += 1
    return out[..., :36].reshape(B, F, 6, 6), out[..., 36:42], out[..., 42], out[..., 43]


def fused_level_sample(data, rel: SE3, image: torch.Tensor, cam: Camera, interpolation="bilinear"):
    """Warped intensities and visibility of every point: one kernel launch
    for all B x F x P points (CUDA tensors), or the plain version (CPU
    tensors). Returns (iwxp (B, F, P) f32, visible (B, F, P) bool)."""
    if data.pcl.device.type == "cpu":
        return fused_level_sample_plain(data, rel, image, cam, interpolation)
    return _launch_sample(data, rel, image, cam, interpolation)


def fused_level_ne(data, rel: SE3, image: torch.Tensor, cam: Camera, interpolation="bilinear"):
    """Raw per-frame normal equations at rel: one kernel launch, `ne_ctas(P)`
    blocks per (pair, frame) (CUDA tensors), or the plain version (CPU
    tensors).
    Returns (A (B, F, 6, 6), b (B, F, 6), chi2 (B, F), n_visible (B, F))."""
    if data.pcl.device.type == "cpu":
        return fused_level_ne_plain(data, rel, image, cam, interpolation)
    return _launch_ne(data, rel, image, cam, interpolation)
