"""Synthetic RGB-D scene rendering for tests and benchmarks (numpy).

A copy of the plane-scene half of `vslam_tpu.io.synthetic`: the port must
run where JAX is not installed. An analytic textured plane gives exact
intensity and depth for any camera pose, so ground-truth alignment checks
need no dataset files.

Scene: a plane n . X = d in world coordinates carrying a smooth procedural
texture (sum of sinusoids). Rendering is closed-form per pixel: intersect the
pixel ray with the plane, evaluate the texture at the hit point.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..core import lie_np

__all__ = ["PlaneScene", "default_scene", "render", "camera_matrix"]


@dataclasses.dataclass(frozen=True)
class PlaneScene:
    normal: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    d: float = 2.0  # plane offset: n . X = d
    origin: Tuple[float, float, float] = (0.0, 0.0, 2.0)  # texture origin on plane
    e1: Tuple[float, float, float] = (1.0, 0.0, 0.0)  # texture axes
    e2: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    seed: int = 7
    n_waves: int = 12
    base_intensity: float = 128.0
    amplitude: float = 90.0


def default_scene(seed: int = 7) -> PlaneScene:
    return PlaneScene(seed=seed)


def camera_matrix(fx, fy, cx, cy) -> np.ndarray:
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=float)


def _texture_params(scene: PlaneScene):
    rng = np.random.default_rng(scene.seed)
    n = scene.n_waves
    # wavelengths 4 cm .. 60 cm on the plane -> strong but smooth gradients
    freqs = 2 * np.pi / rng.uniform(0.04, 0.6, size=(n, 2))
    phases = rng.uniform(0, 2 * np.pi, size=(n, 2))
    amps = rng.uniform(0.3, 1.0, size=n)
    amps = amps / amps.sum() * scene.amplitude
    return freqs, phases, amps


def render(
    K: np.ndarray,
    pose_world_to_cam: np.ndarray,
    shape: Tuple[int, int],
    scene: PlaneScene = PlaneScene(),
) -> Tuple[np.ndarray, np.ndarray]:
    """Render (intensity, depth) float32 arrays for a camera at the given
    world->camera pose. Depth is the camera-frame z of the plane hit; pixels
    whose ray misses the plane (or hits behind) get depth 0 (invalid)."""
    H, W = shape
    T_cw = lie_np.inv(pose_world_to_cam)  # camera -> world
    R_wc = T_cw[:3, :3]
    o = T_cw[:3, 3]  # camera center in world

    Kinv = np.linalg.inv(K)
    xs, ys = np.meshgrid(np.arange(W, dtype=float), np.arange(H, dtype=float))
    rays_cam = np.stack([xs, ys, np.ones_like(xs)], axis=-1) @ Kinv.T
    rays_world = rays_cam @ R_wc.T

    n = np.asarray(scene.normal, dtype=float)
    n = n / np.linalg.norm(n)
    denom = rays_world @ n
    numer = scene.d - o @ n
    with np.errstate(divide="ignore", invalid="ignore"):
        z = numer / denom
    valid = np.isfinite(z) & (z > 0.05)
    z = np.where(valid, z, 0.0)

    X = o[None, None, :] + z[..., None] * rays_world
    p0 = np.asarray(scene.origin, dtype=float)
    a = (X - p0) @ np.asarray(scene.e1, dtype=float)
    b = (X - p0) @ np.asarray(scene.e2, dtype=float)

    freqs, phases, amps = _texture_params(scene)
    tex = scene.base_intensity * np.ones_like(a)
    for k in range(len(amps)):
        tex = tex + amps[k] * np.sin(freqs[k, 0] * a + phases[k, 0]) * np.cos(
            freqs[k, 1] * b + phases[k, 1]
        )
    intensity = np.clip(tex, 0.0, 255.0)
    intensity = np.where(valid, intensity, 0.0)
    return intensity.astype(np.float32), z.astype(np.float32)
