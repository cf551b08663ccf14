"""Keyframe selection policies (reference `odometry/src/KeyFrameSelection.{h,cpp}`).

A copy of `vslam_tpu.odometry.keyframe` (numpy only); the camera and image
size are read from the port's unbatched Frame."""

from __future__ import annotations

import numpy as np

from ..core import lie_np
from .map import HostFrame, Map

__all__ = ["KeyFrameSelectionIdx", "KeyFrameSelectionCustom", "make_keyframe_selection"]


class KeyFrameSelection:
    def update(self, frame: HostFrame) -> None:
        raise NotImplementedError

    def is_keyframe(self) -> bool:
        raise NotImplementedError


class KeyFrameSelectionIdx(KeyFrameSelection):
    """Every Nth frame is a keyframe (KeyFrameSelection.h:36-51)."""

    def __init__(self, period: int = 5):
        self._period = int(period)
        self._ctr = 0

    def update(self, frame: HostFrame) -> None:
        self._ctr += 1

    def is_keyframe(self) -> bool:
        return self._ctr % self._period == 0


class KeyFrameSelectionCustom(KeyFrameSelection):
    """New keyframe when translation from the last keyframe exceeds
    maxTranslation or fewer than minVisiblePoints of its landmarks project
    into the current view (KeyFrameSelection.cpp:30-54)."""

    def __init__(self, slam_map: Map, min_visible_points: int = 80, max_translation: float = 0.2, border: float = 0.0):
        self._map = slam_map
        self._min_visible = int(min_visible_points)
        self._max_translation = float(max_translation)
        self._border = border
        self._visible = 0
        self._rel = np.eye(4)

    def update(self, frame: HostFrame) -> None:
        self._visible = 0
        kf = self._map.last_kf()
        if kf is None:
            return
        self._rel = lie_np.relative(kf.pose, frame.pose)
        if kf.kp_landmark is None or kf.keypoints is None:
            return
        cam = frame.frame.cameras[0]
        fx, fy = float(cam.fx), float(cam.fy)
        cx, cy = float(cam.cx), float(cam.cy)
        W, H = frame.frame.width(0), frame.frame.height(0)
        # vectorized visibility count (no per-landmark Python loop on the
        # per-frame path): batch-fetch positions, project all at once
        pos, ok = self._map.positions_lookup(kf.kp_landmark)
        p_cam = pos @ frame.pose[:3, :3].T + frame.pose[:3, 3]
        z = p_cam[:, 2]
        front = ok & (z > 0)
        zs = np.where(front, z, 1.0)
        u = fx * p_cam[:, 0] / zs + cx
        v = fy * p_cam[:, 1] / zs + cy
        b = self._border
        inb = (b < u) & (u < W - b) & (b < v) & (v < H - b)
        self._visible = int(np.sum(front & inb))

    def is_keyframe(self) -> bool:
        return (
            np.linalg.norm(self._rel[:3, 3]) > self._max_translation
            or self._visible < self._min_visible
        )


def make_keyframe_selection(method: str, slam_map: Map, period: int = 5, min_visible_points: int = 50, max_translation: float = 0.2):
    """Factory mirroring NodeMapping.cpp:94-100."""
    if method == "visible_map":
        return KeyFrameSelectionCustom(slam_map, min_visible_points, max_translation)
    return KeyFrameSelectionIdx(period)
