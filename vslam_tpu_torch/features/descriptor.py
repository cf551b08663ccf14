"""Binary patch descriptors: steered BRIEF-256 (rBRIEF, ORB-style).

Port of `vslam_tpu.features.descriptor` (the role of cv::ORB::compute,
FeatureTracking.cpp:121-135): a 256-bit test pattern drawn once from a
seeded numpy generator, sampled on the twice-blurred image around each
keypoint and steered by the keypoint's intensity-centroid angle
(theta = atan2(m01, m10) over a radius-15 disc). Descriptors are (..., N,
256) float {0, 1} vectors, so descriptor distances are one matmul in the
matcher; they travel packed, 32 bytes a keypoint. Every function takes
leading batch axes.

`torch.round` rounds half to even, as `jnp.round` does; the steered offsets
round the same way in both packages, so a difference can only come from an
angle that differs in its last bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import image as img_ops

__all__ = [
    "brief_pattern",
    "keypoint_orientations",
    "extract_descriptors",
    "pack_bits",
    "unpack_bits",
    "as_float_bits",
    "N_BITS",
    "N_BYTES",
    "PATCH",
    "ORI_RADIUS",
]

N_BITS = 256
N_BYTES = N_BITS // 8  # the packed width (cv::ORB's own 32-byte rows)
PATCH = 24  # half-size of the sampling window
ORI_RADIUS = 15  # intensity-centroid radius


def pack_bits(desc: torch.Tensor) -> torch.Tensor:
    """(..., 256) float or bool bits -> (..., 32) uint8, most significant bit
    first in each byte (np.unpackbits order)."""
    bits = (desc > 0.5).to(torch.uint8).reshape(*desc.shape[:-1], N_BYTES, 8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=desc.device)
    return (bits * weights).sum(dim=-1, dtype=torch.uint8)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 -> (..., 256) float32 of {0, 1} (inverse of pack_bits)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], N_BITS).to(torch.float32)


def as_float_bits(desc: np.ndarray) -> np.ndarray:
    """(N, 256) f32 bit vectors on the host from packed (N, 32) uint8 or
    already unpacked 0/1 rows."""
    desc = np.asarray(desc)
    if desc.dtype == np.uint8 and desc.shape[-1] == N_BYTES:
        return np.unpackbits(desc, axis=-1).astype(np.float32)
    return desc.astype(np.float32)


def brief_pattern(seed: int = 1234) -> np.ndarray:
    """(256, 4) int offsets (x1, y1, x2, y2), Gaussian like the original
    BRIEF pattern, clipped to the patch."""
    rng = np.random.default_rng(seed)
    pts = np.clip(rng.normal(0, PATCH / 3.0, size=(N_BITS, 4)), -PATCH, PATCH)
    return np.round(pts).astype(np.int32)


_PATTERN = brief_pattern()

# the disc of the orientation moments, as offset tables
_YX = np.mgrid[-ORI_RADIUS : ORI_RADIUS + 1, -ORI_RADIUS : ORI_RADIUS + 1]
_CIRC = (_YX[0] ** 2 + _YX[1] ** 2) <= ORI_RADIUS**2
_ORI_DY = _YX[0][_CIRC].astype(np.int32)  # (M,)
_ORI_DX = _YX[1][_CIRC].astype(np.int32)


def _gather(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat (..., H*W) at idx (..., N, M) -> (..., N, M)."""
    lead = idx.shape[:-2]
    return torch.gather(flat, -1, idx.reshape(*lead, -1)).reshape(idx.shape)


def keypoint_orientations(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle of each keypoint: img (..., H, W), uv (...,
    N, 2) pixel coordinates -> (..., N) radians."""
    H, W = img.shape[-2:]
    flat = img.reshape(*img.shape[:-2], H * W)
    u = uv[..., 0].to(torch.int64)
    v = uv[..., 1].to(torch.int64)
    dy = torch.as_tensor(_ORI_DY, dtype=torch.int64, device=img.device)
    dx = torch.as_tensor(_ORI_DX, dtype=torch.int64, device=img.device)
    uu = torch.clamp(u[..., None] + dx, 0, W - 1)
    vv = torch.clamp(v[..., None] + dy, 0, H - 1)
    patch = _gather(flat, vv * W + uu)  # (..., N, M)
    m10 = torch.sum(patch * dx.to(patch.dtype), dim=-1)
    m01 = torch.sum(patch * dy.to(patch.dtype), dim=-1)
    return torch.atan2(m01, m10)


def extract_descriptors(img: torch.Tensor, uv: torch.Tensor, oriented: bool = True) -> torch.Tensor:
    """Descriptors (..., N, 256) float32 of {0, 1} for keypoints uv (..., N,
    2) of img (..., H, W). With ``oriented`` the pattern is rotated per
    keypoint by its centroid angle and re-clipped to +-PATCH. Samples clamp
    at the border; detection keeps PATCH pixels from it, so none does."""
    smooth = img_ops.gaussian_blur_3x3(img_ops.gaussian_blur_3x3(img))
    H, W = img.shape[-2:]
    flat = smooth.reshape(*img.shape[:-2], H * W)
    u = uv[..., 0].to(torch.int64)
    v = uv[..., 1].to(torch.int64)
    pat = torch.as_tensor(_PATTERN, dtype=torch.int64, device=img.device)

    if oriented:
        theta = keypoint_orientations(smooth, uv)
        c = torch.cos(theta)[..., None]
        s = torch.sin(theta)[..., None]

        def rot(px, py):  # (..., N, 256) steered offsets, rounded and re-clipped
            fx = px.to(torch.float32)
            fy = py.to(torch.float32)
            rx = torch.round(c * fx - s * fy).to(torch.int64)
            ry = torch.round(s * fx + c * fy).to(torch.int64)
            return torch.clamp(rx, -PATCH, PATCH), torch.clamp(ry, -PATCH, PATCH)

        dx1, dy1 = rot(pat[:, 0], pat[:, 1])
        dx2, dy2 = rot(pat[:, 2], pat[:, 3])
    else:
        dx1, dy1, dx2, dy2 = pat[:, 0], pat[:, 1], pat[:, 2], pat[:, 3]

    def sample(du, dv):
        uu = torch.clamp(u[..., None] + du, 0, W - 1)
        vv = torch.clamp(v[..., None] + dv, 0, H - 1)
        return _gather(flat, vv * W + uu)

    return (sample(dx1, dy1) < sample(dx2, dy2)).to(torch.float32)
