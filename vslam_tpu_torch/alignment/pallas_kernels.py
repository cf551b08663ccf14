"""Bilinear image sampling at scattered points as a CUDA kernel.

Port of the JAX package's `pallas_kernels.bilinear_sample_mxu_single`, the
`mxu` sampler of `ic.level_normal_equations`; the kernel is
`csrc/sample_mxu.cu`. The TPU kernel samples through one-hot matmuls on the
MXU; the port keeps their semantics, not their formulation: a tap outside
[0, H) x [0, W) contributes 0 (no clamping, negative coordinates included),
and each sample is (wy0 i00 + wy1 i10) wx0 + (wy0 i01 + wy1 i11) wx1.

* `bilinear_sample_mxu(img (B, H, W), u (B, M), v (B, M)) -> (B, M)`, f32;
* `bilinear_sample_mxu_single(img (H, W), u (M,), v (M,)) -> (M,)`, the
  JAX function's unbatched form;
* `bilinear_sample_mxu_plain`, the plain PyTorch twin, on any device.

The wrapper takes the twin for CPU tensors and, for any other device,
launches the kernel or raises; it refuses images of 2^31 pixels or more,
which the kernel's 32-bit tap offsets cannot address.
"""

from __future__ import annotations

import ctypes

import torch

from .fused_solve import _checked

__all__ = [
    "bilinear_sample_mxu",
    "bilinear_sample_mxu_single",
    "bilinear_sample_mxu_plain",
    "MXU_LAUNCHES",
]

# kernel launches made by bilinear_sample_mxu (one per call on CUDA tensors)
MXU_LAUNCHES = 0


def _check_dtype(img: torch.Tensor) -> None:
    if img.dtype != torch.float32:
        raise ValueError(f"image: expected float32, got {img.dtype}")


def bilinear_sample_mxu_plain(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The plain version of `bilinear_sample_mxu`, in the kernel's order."""
    _check_dtype(img)
    B, H, W = img.shape
    u0, v0 = torch.floor(u), torch.floor(v)
    wx1, wy1 = u - u0, v - v0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    # rows v0, v0 + 1 and columns u0, u0 + 1 inside the image
    y0, y1 = (v0 >= 0) & (v0 <= H - 1), (v0 >= -1) & (v0 <= H - 2)
    x0, x1 = (u0 >= 0) & (u0 <= W - 1), (u0 >= -1) & (u0 <= W - 2)
    iv = torch.where(y0 | y1, v0, torch.zeros_like(v0)).long()
    iu = torch.where(x0 | x1, u0, torch.zeros_like(u0)).long()
    flat = img.reshape(B, H * W)

    def tap(ok, dy, dx):
        idx = torch.where(ok, (iv + dy) * W + iu + dx, torch.zeros_like(iv))
        return torch.where(ok, torch.gather(flat, 1, idx), torch.zeros_like(u))

    i00, i01, i10, i11 = tap(y0 & x0, 0, 0), tap(y0 & x1, 0, 1), tap(y1 & x0, 1, 0), tap(y1 & x1, 1, 1)
    return (wy0 * i00 + wy1 * i10) * wx0 + (wy0 * i01 + wy1 * i11) * wx1


# the kernel addresses a tap by its 32-bit offset in its image
MAX_IMAGE_PIXELS = 2**31 - 1


def _launch(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor, lib=None) -> torch.Tensor:
    """The kernel's launch; ``lib`` another build's C entries (a design
    variant or an earlier version, for measurements), by default the
    package's."""
    global MXU_LAUNCHES
    from .._build import library

    B, H, W = img.shape
    M = u.shape[-1]
    if H * W > MAX_IMAGE_PIXELS:
        raise ValueError(f"image of {H}x{W} = {H * W} pixels: the kernel takes fewer than 2^31")
    img = img.contiguous()  # a pyramid level may be a strided view
    _checked("u", u, (B, M), torch.float32)
    _checked("v", v, (B, M), torch.float32)
    _checked("image", img, (B, H, W), torch.float32)
    if min(B, M, H, W) < 1:
        raise ValueError(f"empty problem: B={B} M={M} H={H} W={W}")
    out = torch.empty(B, M, dtype=torch.float32, device=img.device)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = (lib or library()).vslam_bilinear_sample_mxu(
            *(ctypes.c_void_p(t.data_ptr()) for t in (img, u, v)),
            *(ctypes.c_int(x) for x in (B, M, H, W)),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"bilinear_sample_mxu kernel launch failed: CUDA error {err}")
    MXU_LAUNCHES += 1
    return out


def bilinear_sample_mxu(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of B f32 images (B, H, W) at (u, v) (B, M): one
    kernel launch (CUDA tensors) or the plain version (CPU tensors)."""
    _check_dtype(img)
    if img.device.type == "cpu":
        return bilinear_sample_mxu_plain(img, u, v)
    return _launch(img, u, v)


def bilinear_sample_mxu_single(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Unbatched form: img (H, W), u and v (M,) -> (M,)."""
    return bilinear_sample_mxu(img[None], u[None], v[None])[0]
