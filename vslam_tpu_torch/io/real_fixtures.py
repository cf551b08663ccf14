"""Real-image test fixtures from the reference repository.

A copy of `vslam_tpu.io.real_fixtures` (numpy only) on the port's `io.exr`,
`io.tum`, `core.lie_np` and `odometry.trajectory`: the same generators, and
the same loaders reading the same paths.

The reference validates on *real* images at three tiers (SURVEY.md §4):
warp-recovery on rendered/real photos (`test_lukas_kanade_se3.cpp:59-77`,
fixtures `sim.jpg`/`sim.exr`/`person.jpg`), feature tracking invariants on a
real RGB-D pair (`test_tracking.cpp:33-120`, fixtures `rgb.png`/`depth.png`),
and TUM-sequence regression. This module loads those shipped fixtures (when
the reference checkout is present) and provides *exact* view-synthesis
generators so known-ground-truth alignment problems can be posed on real
texture and real depth:

- ``warp_rgbd_pair``: single-pair inverse warp — given a real (I, D) used as
  the CURRENT frame, synthesize the REFERENCE frame such that the IC
  photometric model holds exactly at a chosen relative pose (the residual
  I_cur(proj(rel · backproj(u, D_ref(u)))) − I_ref(u) is identically zero).
- ``render_plane_texture``: a real photo texture-mapped onto a constant-depth
  plane, rendered from any SE(3) pose via the exact plane-induced homography
  (full-SE(3) multi-frame sequences on real texture; the reference's
  commented person.jpg-at-constant-depth variant, test_lukas_kanade_se3.cpp:48-49).
- ``render_rotated_view``: exact novel-view synthesis of a real RGB-D frame
  under pure rotation (depth re-rendered along each new ray).

All functions are host-side numpy (fixture generation, not the compute path).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..core import lie_np

__all__ = [
    "REFERENCE_ROOT",
    "available",
    "load_gray",
    "load_depth_png",
    "load_sim",
    "load_person",
    "load_rgbd_pair",
    "bilinear",
    "resize_half",
    "warp_rgbd_pair",
    "render_plane_texture",
    "render_rotated_view",
    "trajectory_available",
    "load_reference_trajectory",
    "real_trajectory_window",
]

# the reference checkout: $VSLAM_REFERENCE_ROOT, else the default of
# `vslam_tpu.io.real_fixtures`
REFERENCE_ROOT = os.environ.get("VSLAM_REFERENCE_ROOT", os.path.join(os.sep, "root", "reference"))
_LK_RES = os.path.join(REFERENCE_ROOT, "src/vslam/src/lukas_kanade/test/resource")
_ODOM_RES = os.path.join(REFERENCE_ROOT, "src/vslam/src/odometry/test/resource")


def available() -> bool:
    return os.path.isfile(os.path.join(_ODOM_RES, "rgb.png"))


def load_gray(path: str) -> np.ndarray:
    """Decode any 8-bit image to float32 grayscale in [0, 255] (the reference
    `utils::loadImage` converts to gray, `utils.cpp:43-58`)."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"), dtype=np.float32)


def load_depth_png(path: str, scale: float = 1.0 / 5000.0) -> np.ndarray:
    """uint16 depth PNG -> meters (TUM convention, `test_tracking.cpp:35`)."""
    from PIL import Image

    d = np.asarray(Image.open(path), dtype=np.float32) * scale
    return np.where(np.isfinite(d), d, 0.0)


def load_sim() -> Tuple[np.ndarray, np.ndarray]:
    """The rendered sim scene: gray image + float EXR depth
    (`test_lukas_kanade_se3.cpp:43-44`; non-finite depth -> 0 per loadDepth)."""
    from .exr import read_exr

    img = load_gray(os.path.join(_LK_RES, "sim.jpg"))
    depth = read_exr(os.path.join(_LK_RES, "sim.exr"))
    depth = np.where(np.isfinite(depth), depth, 0.0).astype(np.float32)
    return img, depth


def load_person() -> np.ndarray:
    return load_gray(os.path.join(_LK_RES, "person.jpg"))


def load_rgbd_pair() -> Tuple[np.ndarray, np.ndarray]:
    """The real RGB-D fixture (TUM frame): gray [0,255] + depth in meters."""
    img = load_gray(os.path.join(_ODOM_RES, "rgb.png"))
    depth = load_depth_png(os.path.join(_ODOM_RES, "depth.png"))
    return img, depth


def bilinear(img: np.ndarray, u: np.ndarray, v: np.ndarray, fill: float = 0.0):
    """Bilinear sample with out-of-border fill; returns (values, valid)."""
    H, W = img.shape
    valid = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1) & np.isfinite(u) & np.isfinite(v)
    uc = np.clip(np.where(valid, u, 0.0), 0, W - 1.000001)
    vc = np.clip(np.where(valid, v, 0.0), 0, H - 1.000001)
    u0 = np.floor(uc).astype(np.int64)
    v0 = np.floor(vc).astype(np.int64)
    u1 = np.minimum(u0 + 1, W - 1)
    v1 = np.minimum(v0 + 1, H - 1)
    fu = uc - u0
    fv = vc - v0
    val = (
        img[v0, u0] * (1 - fu) * (1 - fv)
        + img[v0, u1] * fu * (1 - fv)
        + img[v1, u0] * (1 - fu) * fv
        + img[v1, u1] * fu * fv
    )
    return np.where(valid, val, fill).astype(np.float32), valid


def resize_half(img: np.ndarray, times: int = 1) -> np.ndarray:
    """Area-downsample by 2 `times` times (the reference tests run sim at
    0.25 scale, `test_lukas_kanade_se3.cpp:46-47`)."""
    out = img
    for _ in range(times):
        H, W = out.shape
        out = 0.25 * (out[0 : H - 1 : 2, 0 : W - 1 : 2] + out[1:H:2, 0 : W - 1 : 2]
                      + out[0 : H - 1 : 2, 1:W:2] + out[1:H:2, 1:W:2])
    return out.astype(np.float32)


def _grid(H: int, W: int):
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    return xs, ys


def warp_rgbd_pair(
    intensity: np.ndarray,
    depth: np.ndarray,
    K: np.ndarray,
    rel: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Synthesize the REFERENCE frame for a given CURRENT frame and relative
    pose ``rel`` (cur <- ref), such that the IC photometric model is exact:

        I_ref(u) := I_cur(proj(rel · backproj(u, D(u)))),   D_ref := D

    Like a real RGB-D camera, the synthesized frame has *complete* intensity
    (out-of-view samples are border-clamped — smooth smears, no artificial
    zero-edges that would fabricate huge gradients) while depth carries the
    holes (0 where the warp leaves the view or the source depth is invalid);
    the aligner's 3x3-valid-depth interest rule excludes those regions."""
    H, W = intensity.shape
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xs, ys = _grid(H, W)
    dvalid = np.isfinite(depth) & (depth > 0)
    z = np.where(dvalid, depth, 1.0)
    p = np.stack([(xs - cx) / fx * z, (ys - cy) / fy * z, z], axis=-1)
    q = p @ rel[:3, :3].T + rel[:3, 3]
    zq = q[..., 2]
    front = zq > 1e-6
    zq_safe = np.where(front, zq, 1.0)
    u = fx * q[..., 0] / zq_safe + cx
    v = fy * q[..., 1] / zq_safe + cy
    u = np.where(np.isfinite(u), u, 0.0)
    v = np.where(np.isfinite(v), v, 0.0)
    inview = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    val, _ = bilinear(
        intensity, np.clip(u, 0, W - 1.000001), np.clip(v, 0, H - 1.000001)
    )
    ok = dvalid & front & inview
    return (
        val.astype(np.float32),
        np.where(ok, depth, 0.0).astype(np.float32),
    )


def render_plane_texture(
    texture: np.ndarray,
    K: np.ndarray,
    pose_world_to_cam: np.ndarray,
    plane_depth: float = 2.0,
    shape: Optional[Tuple[int, int]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Render a real photo texture-mapped on the world plane z = plane_depth.

    The texture is anchored so a camera at identity sees the photo exactly
    (pixel-for-pixel). Returns (intensity, depth); rays missing the plane or
    the texture get intensity 0 / depth 0."""
    H, W = shape if shape is not None else texture.shape
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    T_cw = lie_np.inv(pose_world_to_cam)
    R_wc, o = T_cw[:3, :3], T_cw[:3, 3]
    xs, ys = _grid(H, W)
    rays_cam = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)], axis=-1)
    rays_w = rays_cam @ R_wc.T
    denom = rays_w[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        s = (plane_depth - o[2]) / denom
    valid = np.isfinite(s) & (s > 1e-3)
    X = o[None, None, :] + np.where(valid, s, 0.0)[..., None] * rays_w
    # anchor: identity camera pixel of plane point (x, y, plane_depth)
    tu = fx * X[..., 0] / plane_depth + cx
    tv = fy * X[..., 1] / plane_depth + cy
    val, tvis = bilinear(texture, tu, tv)
    # depth = camera-frame z of the hit (ray_cam.z == 1 -> z = s scaled back
    # through the rotation): z_cam = (R_cw (X - o)).z = s * rays_cam.z = s
    ok = valid & tvis
    return (
        np.where(ok, val, 0.0).astype(np.float32),
        np.where(ok, s, 0.0).astype(np.float32),
    )


def render_rotated_view(
    intensity: np.ndarray,
    depth: np.ndarray,
    K: np.ndarray,
    R: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact novel view of a real RGB-D frame under pure rotation ``R``
    (new_cam <- orig_cam). For pixel u of the new view with ray d = K^-1 u:
    the original ray is Rᵀd, hit at original pixel u0 with depth z0; the
    point distance along the new ray follows s = z0 / (Rᵀd).z and the new
    z-depth is s (rays normalized to unit z)."""
    H, W = intensity.shape
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xs, ys = _grid(H, W)
    d_new = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)], axis=-1)
    d_old = d_new @ R  # Rᵀ d, row-vector form
    z_old = d_old[..., 2]
    front = z_old > 1e-6
    z_safe = np.where(front, z_old, 1.0)
    u0 = fx * d_old[..., 0] / z_safe + cx
    v0 = fy * d_old[..., 1] / z_safe + cy
    val, vis = bilinear(intensity, u0, v0)
    z0, _ = bilinear(depth, u0, v0)
    # invalidate depth where the source 3x3 window has holes or a strong
    # discontinuity: bilinear depth resampling across an occlusion boundary
    # fabricates points that exist on neither surface
    H2, W2 = depth.shape
    dpad = np.pad(depth, 1, mode="edge")
    wins = np.stack([
        dpad[dy : dy + H2, dx : dx + W2] for dy in range(3) for dx in range(3)
    ])
    dmin, dmax = wins.min(axis=0), wins.max(axis=0)
    smooth = (dmin > 0) & ((dmax - dmin) < 0.05 * np.maximum(dmin, 1e-6) + 0.02)
    src_ok, _ = bilinear(smooth.astype(np.float32), u0, v0)
    ok = front & vis & (z0 > 0) & (src_ok > 0.999)
    z_new = np.where(ok, z0 / z_safe, 0.0)
    return (
        np.where(ok, val, 0.0).astype(np.float32),
        z_new.astype(np.float32),
    )


# ---------------------------------------------------------------------------
# Real fr2_desk ground-truth trajectory (the reference ships ~70 s of the
# sequence's motion-capture track at ~300 Hz as a test fixture:
# odometry/test/resource/trajectory.txt, loaded by test_trajectory.cpp:34).
# No images — but the real CAMERA MOTION, which is what the synthetic-scene
# odometry gates replay so their motion profile is fr2_desk's, not an
# invented sinusoid.
# ---------------------------------------------------------------------------

_TRAJ_PATH = os.path.join(_ODOM_RES, "trajectory.txt")


def trajectory_available() -> bool:
    return os.path.isfile(_TRAJ_PATH)


def load_reference_trajectory():
    """The shipped fr2_desk ground-truth track as {t_s: cam->world 4x4}
    (TUM format, reference utils::loadTrajectory semantics)."""
    from . import tum

    return tum.read_trajectory(_TRAJ_PATH)


def real_trajectory_window(
    n_frames: int, hz: float = 30.0, start_s: float = 5.0
) -> list:
    """n_frames WORLD->CAMERA poses sampled at `hz` from the real fr2_desk
    ground-truth track, normalized so the first pose is identity (the same
    convention `synthetic.render` + the bench gates use). Sampling uses the
    Trajectory class's constant-velocity interpolation (Trajectory.cpp:48-70
    semantics), so the window is exactly the real camera motion."""
    from ..odometry.trajectory import Trajectory

    gt = load_reference_trajectory()
    traj = Trajectory({int(t * 1e9): np.linalg.inv(T) for t, T in gt.items()})
    ts = traj.timestamps
    t0 = ts[0] + int(start_s * 1e9)
    if t0 + int((n_frames - 1) / hz * 1e9) > ts[-1]:
        raise ValueError(f"window of {n_frames} frames at {hz} Hz exceeds fixture span")
    poses = [traj.pose_at(t0 + int(i / hz * 1e9)) for i in range(n_frames)]
    p0i = lie_np.inv(poses[0])
    return [p @ p0i for p in poses]
