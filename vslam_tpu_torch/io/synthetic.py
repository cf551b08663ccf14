"""Synthetic RGB-D scene rendering for tests and benchmarks (numpy).

A copy of the numpy half of `vslam_tpu.io.synthetic` (the plane and box
scenes, the orbit and smooth trajectories): the port must run where JAX is
not installed. Analytic scenes give exact intensity and depth for any camera
pose, so ground-truth alignment and odometry checks need no dataset files.
The device-batched `render_boxes_batch` is not ported yet.

Scene: a plane n . X = d in world coordinates carrying a smooth procedural
texture (sum of sinusoids). Rendering is closed-form per pixel: intersect the
pixel ray with the plane, evaluate the texture at the hit point.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..core import lie_np

__all__ = [
    "PlaneScene",
    "BoxScene",
    "default_scene",
    "render",
    "render_boxes",
    "camera_matrix",
    "orbit_trajectory",
    "smooth_trajectory",
]


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


@dataclasses.dataclass(frozen=True)
class BoxScene:
    """A scene with DEPTH DISCONTINUITIES: a textured background plane plus a
    set of textured foreground rectangular patches at different depths and
    orientations, rendered with a z-buffer — pixel rays hitting a closer
    patch occlude the background, producing the occlusion edges, parallax and
    invalid-at-boundary behavior real RGB-D frames have (the analytic
    PlaneScene is C-infinity everywhere and is the *easy* case)."""

    seed: int = 11
    n_patches: int = 6
    background: PlaneScene = PlaneScene(d=2.5, origin=(0.0, 0.0, 2.5))
    # world-unit multiplier on patch placement/extent: scale=1 is the room
    # layout (patches 1.2-2.1 m ahead); scale=5 with a d=12.5 background is
    # a street-depth layout for KITTI-geometry scenes — texture wavelengths
    # are left in absolute units (4-60 cm) so the pixel footprint stays
    # resolvable at the scaled distance through KITTI focal lengths
    scale: float = 1.0


def _patch_params(scene: BoxScene):
    rng = np.random.default_rng(scene.seed)
    patches = []
    for k in range(scene.n_patches):
        # patch center in front of the background, tilted plane, finite extent
        c = np.array([rng.uniform(-0.8, 0.8), rng.uniform(-0.6, 0.6), rng.uniform(1.2, 2.1)])
        tilt = rng.uniform(-0.5, 0.5, size=2)
        n = np.array([tilt[0], tilt[1], -1.0])
        n /= np.linalg.norm(n)
        e1 = np.cross(n, [0.0, 1.0, 0.0])
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(n, e1)
        half = rng.uniform(0.15, 0.45, size=2)
        tex = PlaneScene(seed=scene.seed * 101 + k, n_waves=10, amplitude=80.0)
        patches.append((c * scene.scale, n, e1, e2, half * scene.scale, tex))
    return patches


def render_boxes(
    K: np.ndarray,
    pose_world_to_cam: np.ndarray,
    shape: Tuple[int, int],
    scene: BoxScene = BoxScene(),
) -> Tuple[np.ndarray, np.ndarray]:
    """Render the occlusion scene: closed-form per pixel, exact GT for any
    pose. Returns (intensity, depth) like `render`."""
    H, W = shape
    intensity, depth = render(K, pose_world_to_cam, shape, scene.background)

    T_cw = lie_np.inv(pose_world_to_cam)
    R_wc = T_cw[:3, :3]
    o = T_cw[:3, 3]
    Kinv = np.linalg.inv(K)
    xs, ys = np.meshgrid(np.arange(W, dtype=float), np.arange(H, dtype=float))
    rays_world = (np.stack([xs, ys, np.ones_like(xs)], axis=-1) @ Kinv.T) @ R_wc.T

    zbuf = np.where(depth > 0, depth, np.inf)
    for c, n, e1, e2, half, tex in _patch_params(scene):
        denom = rays_world @ n
        numer = (c - o) @ n
        with np.errstate(divide="ignore", invalid="ignore"):
            z = numer / denom
        hit = np.isfinite(z) & (z > 0.05)
        X = o[None, None, :] + np.where(hit, z, 0.0)[..., None] * rays_world
        a = (X - c) @ e1
        b = (X - c) @ e2
        hit &= (np.abs(a) < half[0]) & (np.abs(b) < half[1]) & (z < zbuf)
        freqs, phases, amps = _texture_params(tex)
        t = tex.base_intensity * np.ones_like(a)
        for k in range(len(amps)):
            t = t + amps[k] * np.sin(freqs[k, 0] * a + phases[k, 0]) * np.cos(
                freqs[k, 1] * b + phases[k, 1]
            )
        intensity = np.where(hit, np.clip(t, 0.0, 255.0), intensity)
        zbuf = np.where(hit, z, zbuf)
    depth = np.where(np.isfinite(zbuf), zbuf, 0.0)
    return intensity.astype(np.float32), depth.astype(np.float32)


def orbit_trajectory(
    n_frames: int,
    radius: float = 0.2,
    height: float = 0.05,
    yaw: float = 0.1,
) -> list:
    """Closed circular orbit in the x/y plane, always facing the scene:
    the camera traverses a circle and returns EXACTLY to the start pose
    without ever retracing its path. Unlike `loop_trajectory` (out-and-back,
    where odometry drift on the return leg anti-correlates with the outbound
    leg and largely self-cancels at the revisit), a non-retracing orbit
    accumulates drift monotonically around the loop — the closure at the
    revisit observes the FULL accumulated drift, which is the regime where
    online correction folding is signal-dominated (the classic loop-closure
    demonstration). Constant-speed circular motion = constant twist, so
    constant-motion prediction stays valid."""
    poses = []
    for i in range(n_frames):
        th = 2 * np.pi * i / max(n_frames - 1, 1)
        T = np.eye(4)
        T[0, 3] = radius * np.sin(th)
        T[1, 3] = radius * (1.0 - np.cos(th)) * 0.5 + height * np.sin(2 * th)
        xi = np.zeros(6)
        xi[4] = yaw * np.sin(th)  # gentle yaw wiggle keeps views distinct
        T = T @ lie_np.exp(xi)
        poses.append(T)
    return poses


def smooth_trajectory(
    n_frames: int,
    dt: float = 1.0 / 30.0,
    trans_amp: float = 0.15,
    rot_amp: float = 0.05,
    seed: int = 3,
) -> list:
    """Smooth world->camera pose sequence (sinusoidal twist), n_frames 4x4s."""
    rng = np.random.default_rng(seed)
    w_t = rng.uniform(0.3, 1.2, size=3)
    w_r = rng.uniform(0.3, 1.0, size=3)
    ph = rng.uniform(0, 2 * np.pi, size=6)
    poses = []
    for i in range(n_frames):
        t = i * dt
        xi = np.zeros(6)
        xi[:3] = trans_amp * np.sin(w_t * t + ph[:3])
        xi[3:] = rot_amp * np.sin(w_r * t + ph[3:])
        poses.append(lie_np.exp(xi))
    return poses
