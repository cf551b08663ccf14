"""Pinhole camera model on torch tensors.

Port of `vslam_tpu.core.camera`: projection returns a validity mask instead
of NaN (the reference returns NaN where z <= 0, `Camera.cpp:4-11`).

Camera leaves are tensors of any batch shape: () for one camera, (B,) for
one per pair. `expand` reshapes them to broadcast against an array whose
leading axes start with that batch shape.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .device import resolve

__all__ = ["Camera", "project", "backproject", "ray", "scale", "intrinsic_matrix", "expand"]


class Camera(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor

    @staticmethod
    def create(fx, fy, cx, cy, dtype=torch.float32, device=None) -> "Camera":
        """Intrinsics on ``device``, CUDA unless named."""
        dev = resolve(device)
        return Camera(*(torch.as_tensor(v, dtype=dtype, device=dev) for v in (fx, fy, cx, cy)))


def expand(cam: Camera, ndim: int) -> Camera:
    """Append singleton axes so every leaf has ``ndim`` axes (leaves of shape
    (B,) become (B, 1, ..., 1) and broadcast against (B, ...) arrays)."""
    return Camera(*(c.reshape(c.shape + (1,) * (ndim - c.dim())) for c in cam))


def project(cam: Camera, p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project camera-frame points ``p: (..., 3)`` to pixels; camera leaves
    broadcast against ``p[..., 0]``. Returns ``(uv, valid)`` with
    ``valid = z > 0`` and finite uv everywhere."""
    z = p[..., 2]
    valid = z > 0
    z_safe = torch.where(valid, z, torch.ones_like(z))
    u = cam.fx * p[..., 0] / z_safe + cam.cx
    v = cam.fy * p[..., 1] / z_safe + cam.cy
    return torch.stack([u, v], dim=-1), valid


def backproject(cam: Camera, uv: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Camera-frame points from pixels ``uv: (..., 2)`` and depth ``z``
    (reference `Camera.cpp:13-16` image2camera)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * z
    y = (uv[..., 1] - cam.cy) / cam.fy * z
    return torch.stack([x, y, z], dim=-1)


def ray(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Unit-depth ray through pixel uv (reference image2ray)."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def scale(cam: Camera, s: float) -> Camera:
    """Rescale intrinsics for a resized image (reference `Camera.cpp:34-38`:
    fx, fy, cx, cy times s, no half-pixel correction)."""
    return Camera(cam.fx * s, cam.fy * s, cam.cx * s, cam.cy * s)


def intrinsic_matrix(cam: Camera) -> torch.Tensor:
    """K (..., 3, 3) from leaves of any batch shape."""
    fx = torch.as_tensor(cam.fx)
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    rows = [torch.stack([fx, zero, torch.as_tensor(cam.cx)], dim=-1),
            torch.stack([zero, torch.as_tensor(cam.fy), torch.as_tensor(cam.cy)], dim=-1),
            torch.stack([zero, zero, one], dim=-1)]
    return torch.stack(rows, dim=-2)
