"""SE(3) / SO(3) Lie-group operations on torch tensors.

Port of `vslam_tpu.core.se3`. Tangent ordering follows Sophus, as the
reference does: ``xi = [rho; phi]``, translation first. Transforms are
``(R (..., 3, 3), t (..., 3))`` and every function broadcasts over leading
batch axes (the port's explicit pair axis B and frame axis F).
Small-angle switches use ``torch.where`` with safe operands, as in the JAX
version, so the results match it branch for branch.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = [
    "SE3",
    "identity",
    "compose",
    "inverse",
    "transform_points",
    "so3_hat",
    "so3_log",
    "exp",
    "log",
    "adjoint",
    "orthonormalize",
]


class SE3(NamedTuple):
    """Rigid transform as rotation matrix + translation."""

    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)


def identity(batch_shape=(), dtype=torch.float32, device=None) -> SE3:
    R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3).clone()
    t = torch.zeros(*batch_shape, 3, dtype=dtype, device=device)
    return SE3(R, t)


def compose(a: SE3, b: SE3) -> SE3:
    """a . b — apply b first, then a."""
    R = a.R @ b.R
    t = (a.R @ b.t.unsqueeze(-1)).squeeze(-1) + a.t
    return SE3(R, t)


def inverse(g: SE3) -> SE3:
    Rt = g.R.transpose(-1, -2)
    return SE3(Rt, -(Rt @ g.t.unsqueeze(-1)).squeeze(-1))


def transform_points(g: SE3, p: torch.Tensor) -> torch.Tensor:
    """Apply the transform to points ``p: (..., 3)``; batch axes of ``g``
    broadcast against the leading axes of ``p``."""
    return (g.R @ p.unsqueeze(-1)).squeeze(-1) + g.t


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of ``w: (..., 3)``."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    rows = [
        torch.stack([zero, -wz, wy], dim=-1),
        torch.stack([wz, zero, -wx], dim=-1),
        torch.stack([-wy, wx, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def _so3_vee(W: torch.Tensor) -> torch.Tensor:
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta2: torch.Tensor):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t-sin t)/t^3), Taylor-safe."""
    theta2_safe = torch.clamp(theta2, min=1e-24)
    theta = torch.sqrt(theta2_safe)
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    C = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2_safe * theta)
    )
    return A, B, C


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map of SO(3), robust near theta = 0 and theta = pi (the
    atan2 form of `vslam_tpu.core.se3.so3_log`)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    vee = _so3_vee(R - R.transpose(-1, -2))  # = 2 sin(theta) * axis
    sin2 = torch.sum(vee * vee, dim=-1) * 0.25
    sin_theta = torch.sqrt(torch.clamp(sin2, min=1e-30))
    theta = torch.atan2(sin_theta, cos_theta)
    theta2 = theta * theta

    small = theta < 1e-4
    factor = torch.where(
        small, 0.5 + theta2 / 12.0, theta / torch.clamp(2.0 * sin_theta, min=1e-24)
    )
    w_generic = factor.unsqueeze(-1) * vee

    # near pi: axis from the column of (R + I) with the largest diagonal
    Rp = R + torch.eye(3, dtype=R.dtype, device=R.device)
    diag = torch.stack([Rp[..., 0, 0], Rp[..., 1, 1], Rp[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    idx = k[..., None, None].expand(*k.shape, 3, 1)
    cols = torch.take_along_dim(Rp, idx, dim=-1)[..., 0]
    cols_norm = torch.sqrt(torch.clamp(torch.sum(cols * cols, dim=-1, keepdim=True), min=1e-24))
    w_pi = cols / cols_norm * theta.unsqueeze(-1)
    sign = torch.where(torch.sum(vee * w_pi, dim=-1, keepdim=True) < 0, -1.0, 1.0)
    w_pi = w_pi * sign

    near_pi = theta > (math.pi - 1e-3)
    return torch.where(near_pi.unsqueeze(-1), w_pi, w_generic)


def exp(xi: torch.Tensor) -> SE3:
    """Exponential map. ``xi = [rho(3); phi(3)]`` (translation first)."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    theta2 = torch.sum(phi * phi, dim=-1)
    A, B, C = _sinc_coeffs(theta2)
    W = so3_hat(phi)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    return SE3(R, (V @ rho.unsqueeze(-1)).squeeze(-1))


def log(g: SE3) -> torch.Tensor:
    """Logarithm map; returns ``xi = [rho; phi]``."""
    phi = so3_log(g.R)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta2_safe = torch.clamp(theta2, min=1e-24)
    theta = torch.sqrt(theta2_safe)
    half = 0.5 * theta
    small = theta2 < 1e-8
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half), min=1e-24)) / theta2_safe,
    )
    W = so3_hat(phi)
    W2 = W @ W
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    Vinv = eye - 0.5 * W + cot_term[..., None, None] * W2
    rho = (Vinv @ g.t.unsqueeze(-1)).squeeze(-1)
    return torch.cat([rho, phi], dim=-1)


def adjoint(g: SE3) -> torch.Tensor:
    """6x6 adjoint (..., 6, 6) mapping tangent vectors between frames,
    ordering [rho; phi]: [[R, t^ R], [0, R]]."""
    top = torch.cat([g.R, so3_hat(g.t) @ g.R], dim=-1)
    bottom = torch.cat([torch.zeros_like(g.R), g.R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def orthonormalize(g: SE3) -> SE3:
    """Project R back onto SO(3) via Gram-Schmidt of columns r0, r1."""
    r0 = g.R[..., :, 0]
    r1 = g.R[..., :, 1]
    x = r0 / torch.clamp(torch.linalg.vector_norm(r0, dim=-1, keepdim=True), min=1e-24)
    z = _cross(x, r1)
    z = z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True), min=1e-24)
    y = _cross(z, x)
    return SE3(torch.stack([x, y, z], dim=-1), g.t)
