"""Host-side SE(3) in float64 numpy.

The device pipeline (alignment, batched tracking) works exclusively on small
*relative* transforms in f32; the unbounded *absolute* pose chain (trajectory
accumulation, prediction, keyframe bookkeeping) is composed on the host in
f64, exactly where the reference keeps its Sophus::SE3d state. Same tangent
ordering as `vslam_tpu_torch.core.se3`: xi = [rho; phi]. A copy of
`vslam_tpu.core.lie_np`: the port must import without JAX.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "identity",
    "exp",
    "log",
    "inv",
    "compose",
    "relative",
    "transform",
    "rotvec_to_matrix",
    "matrix_to_rotvec",
    "adjoint",
]


def identity() -> np.ndarray:
    return np.eye(4)


def _hat(w):
    return np.array(
        [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]], dtype=float
    )


def rotvec_to_matrix(w: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(w)
    W = _hat(w)
    if theta < 1e-10:
        return np.eye(3) + W + 0.5 * W @ W
    A = np.sin(theta) / theta
    B = (1 - np.cos(theta)) / theta**2
    return np.eye(3) + A * W + B * W @ W


def matrix_to_rotvec(R: np.ndarray) -> np.ndarray:
    cos_theta = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    theta = np.arccos(cos_theta)
    if theta < 1e-10:
        return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2
    if theta > np.pi - 1e-6:
        # near pi: axis from diagonal of (R + I)/2
        M = (R + np.eye(3)) / 2
        axis = np.sqrt(np.maximum(np.diag(M), 0))
        k = int(np.argmax(axis))
        axis = M[:, k] / max(np.linalg.norm(M[:, k]), 1e-12)
        return axis * theta
    vee = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return theta / (2 * np.sin(theta)) * vee


def exp(xi: np.ndarray) -> np.ndarray:
    """4x4 transform from xi = [rho; phi]."""
    xi = np.asarray(xi, dtype=float)
    rho, phi = xi[:3], xi[3:]
    theta = np.linalg.norm(phi)
    W = _hat(phi)
    W2 = W @ W
    if theta < 1e-10:
        V = np.eye(3) + 0.5 * W + W2 / 6.0
        R = np.eye(3) + W + 0.5 * W2
    else:
        A = np.sin(theta) / theta
        B = (1 - np.cos(theta)) / theta**2
        C = (theta - np.sin(theta)) / theta**3
        R = np.eye(3) + A * W + B * W2
        V = np.eye(3) + B * W + C * W2
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ rho
    return T


def log(T: np.ndarray) -> np.ndarray:
    R, t = T[:3, :3], T[:3, 3]
    phi = matrix_to_rotvec(R)
    theta = np.linalg.norm(phi)
    W = _hat(phi)
    W2 = W @ W
    if theta < 1e-10:
        Vinv = np.eye(3) - 0.5 * W + W2 / 12.0
    else:
        half = theta / 2
        D = (1 - half * np.cos(half) / np.sin(half)) / theta**2
        Vinv = np.eye(3) - 0.5 * W + D * W2
    return np.concatenate([Vinv @ t, phi])


def inv(T: np.ndarray) -> np.ndarray:
    out = np.eye(4)
    Rt = T[:3, :3].T
    out[:3, :3] = Rt
    out[:3, 3] = -Rt @ T[:3, 3]
    return out


def compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return a @ b


def relative(t0: np.ndarray, t1: np.ndarray) -> np.ndarray:
    """t1 . t0^-1 (reference algorithm.cpp:82-85)."""
    return t1 @ inv(t0)


def transform(T: np.ndarray, p: np.ndarray) -> np.ndarray:
    return p @ T[:3, :3].T + T[:3, 3]


def adjoint(T: np.ndarray) -> np.ndarray:
    R, t = T[:3, :3], T[:3, 3]
    A = np.zeros((6, 6))
    A[:3, :3] = R
    A[:3, 3:] = _hat(t) @ R
    A[3:, 3:] = R
    return A
