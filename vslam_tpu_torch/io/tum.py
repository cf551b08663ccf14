"""TUM RGB-D dataset reader and trajectory file IO.

A copy of `vslam_tpu.io.tum` (numpy only); PNGs decode through the port's
`io.native_loader` where it builds, else through PIL, imported where a
frame is read.

Rebuilds the reference's dataset plumbing without ROS:
- trajectory read/write in TUM format `timestamp tx ty tz qx qy qz qw`
  (reference utils::loadTrajectory/writeTrajectory, `utils.cpp:76-132`, and
  NodeResultWriter.cpp:23-31)
- rgb/depth pairing by closest timestamp, replacing the mutexed Queue
  (`src/ros/Queue.cpp:40-102`, max pairing difference 0.2 s)
- PNG loading via PIL; TUM depth PNGs are uint16 with scale 1/5000 m.

Trajectory files hold cam->world poses (TUM convention). The pipeline's
internal convention is world->cam; conversion happens here at the boundary.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core import lie_np

__all__ = [
    "read_trajectory",
    "write_trajectory",
    "TumDataset",
    "quat_to_matrix",
    "matrix_to_quat",
]

DEPTH_SCALE = 1.0 / 5000.0  # TUM depth png -> meters
MAX_PAIR_DIFF_S = 0.2  # Queue.cpp popClosest threshold


def quat_to_matrix(qx, qy, qz, qw) -> np.ndarray:
    q = np.array([qw, qx, qy, qz], dtype=float)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def matrix_to_quat(R: np.ndarray) -> Tuple[float, float, float, float]:
    """Returns (qx, qy, qz, qw)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        if i == 0:
            s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
            qw = (R[2, 1] - R[1, 2]) / s
            qx = 0.25 * s
            qy = (R[0, 1] + R[1, 0]) / s
            qz = (R[0, 2] + R[2, 0]) / s
        elif i == 1:
            s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
            qw = (R[0, 2] - R[2, 0]) / s
            qx = (R[0, 1] + R[1, 0]) / s
            qy = 0.25 * s
            qz = (R[1, 2] + R[2, 1]) / s
        else:
            s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
            qw = (R[1, 0] - R[0, 1]) / s
            qx = (R[0, 2] + R[2, 0]) / s
            qy = (R[1, 2] + R[2, 1]) / s
            qz = 0.25 * s
    return float(qx), float(qy), float(qz), float(qw)


def read_trajectory(path: str) -> Dict[float, np.ndarray]:
    """timestamp [s] -> cam->world 4x4."""
    out: Dict[float, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(",", " ").split()
            if len(parts) < 8:
                continue
            t, tx, ty, tz, qx, qy, qz, qw = (float(x) for x in parts[:8])
            T = np.eye(4)
            T[:3, :3] = quat_to_matrix(qx, qy, qz, qw)
            T[:3, 3] = [tx, ty, tz]
            out[t] = T
    return out


def write_trajectory(
    path: str,
    poses: Dict[float, np.ndarray],
    covs: Optional[Dict[float, np.ndarray]] = None,
) -> None:
    """Write TUM-format rows; if covariances are given, append the 36 row-major
    entries exactly like NodeResultWriter (NodeResultWriter.cpp:23-31)."""
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for t in sorted(poses.keys()):
            T = poses[t]
            qx, qy, qz, qw = matrix_to_quat(T[:3, :3])
            tx, ty, tz = T[:3, 3]
            row = f"{t:.9f} {tx:.6f} {ty:.6f} {tz:.6f} {qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}"
            if covs is not None and t in covs:
                row += " " + " ".join(f"{c:.9g}" for c in np.asarray(covs[t]).ravel())
            f.write(row + "\n")


def _read_file_list(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def _load_png(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path))


def _use_native() -> bool:
    try:
        from . import native_loader

        return native_loader.native_available()
    except Exception:
        return False


class TumDataset:
    """Iterates (t_ns, intensity f32 [0,255], depth f32 meters) over a TUM
    RGB-D sequence directory (rgb.txt / depth.txt / groundtruth.txt).

    Pairing follows the reference Queue semantics: for each rgb timestamp the
    closest depth within 0.2 s (Queue.cpp:40-102); unmatched frames drop.
    """

    # fr1/fr2/fr3 calibrated intrinsics (TUM benchmark website values)
    INTRINSICS = {
        "freiburg1": (517.3, 516.5, 318.6, 255.3),
        "freiburg2": (520.9, 521.0, 325.1, 249.7),
        "freiburg3": (535.4, 539.2, 320.1, 247.6),
        "default": (525.0, 525.0, 319.5, 239.5),
    }

    def __init__(self, root: str, max_frames: Optional[int] = None):
        self.root = root
        rgb = _read_file_list(os.path.join(root, "rgb.txt"))
        depth = _read_file_list(os.path.join(root, "depth.txt"))
        ts_d = np.asarray([t for t, _ in depth])
        self.pairs: List[Tuple[float, str, str]] = []
        # pop semantics like the reference Queue (Queue.cpp:40-102): each
        # depth frame is consumed by at most one rgb frame — a two-pointer
        # sweep over the time-sorted lists (never reuse one depth image for
        # several rgb frames)
        j = 0
        for t_rgb, f_rgb in rgb:
            while j + 1 < len(depth) and abs(ts_d[j + 1] - t_rgb) <= abs(ts_d[j] - t_rgb):
                j += 1
            if j < len(depth) and abs(ts_d[j] - t_rgb) <= MAX_PAIR_DIFF_S:
                self.pairs.append((t_rgb, f_rgb, depth[j][1]))
                j += 1
            if j >= len(depth):
                break
        if max_frames:
            self.pairs = self.pairs[:max_frames]
        gt_path = os.path.join(root, "groundtruth.txt")
        self.groundtruth = read_trajectory(gt_path) if os.path.exists(gt_path) else {}

    def intrinsics(self) -> Tuple[float, float, float, float]:
        name = os.path.basename(os.path.normpath(self.root)).lower()
        for key, k in self.INTRINSICS.items():
            if key in name:
                return k
        return self.INTRINSICS["default"]

    def __len__(self) -> int:
        return len(self.pairs)

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
        if _use_native():
            # threaded native prefetch loader (decode overlaps TPU compute)
            from .native_loader import NativeFrameLoader

            loader = NativeFrameLoader(
                [os.path.join(self.root, f) for _, f, _ in self.pairs],
                [os.path.join(self.root, f) for _, _, f in self.pairs],
                depth_scale=DEPTH_SCALE,
            )
            for (t, _, _), (gray, depth) in zip(self.pairs, loader):
                yield int(t * 1e9), gray, depth
            loader.close()
            return
        for t, f_rgb, f_depth in self.pairs:
            rgb = _load_png(os.path.join(self.root, f_rgb)).astype(np.float32)
            if rgb.ndim == 3:
                # Rec.601 grayscale, matching cv::IMREAD_GRAYSCALE in
                # utils::loadImage (utils.cpp:43-58)
                rgb = rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114
            d = _load_png(os.path.join(self.root, f_depth)).astype(np.float32) * DEPTH_SCALE
            yield int(t * 1e9), rgb, d

    def iter_raw(self) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
        """Frames in their native sensor dtypes: (t_ns, uint8 gray, uint16
        depth counts — metres = counts * DEPTH_SCALE). The device converts;
        the host->device link moves 4x less than the f32 stream (see
        PipelineConfig.depth_scale / SequentialConfig.depth_scale). Grayscale
        uses the same Rec.601 weights as cv::IMREAD_GRAYSCALE, rounded to u8.
        Uses the native threaded prefetch loader when built."""
        if _use_native():
            from .native_loader import NativeFrameLoader

            loader = NativeFrameLoader(
                [os.path.join(self.root, f) for _, f, _ in self.pairs],
                [os.path.join(self.root, f) for _, _, f in self.pairs],
                raw=True,
            )
            for (t, _, _), (gray, depth) in zip(self.pairs, loader):
                yield int(t * 1e9), gray, depth
            loader.close()
            return
        from PIL import Image

        for t, f_rgb, f_depth in self.pairs:
            rgb = np.asarray(Image.open(os.path.join(self.root, f_rgb)))
            if rgb.ndim == 3:
                rgb = np.round(
                    rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114
                )
            d = np.asarray(Image.open(os.path.join(self.root, f_depth)))
            yield int(t * 1e9), rgb.astype(np.uint8), d.astype(np.uint16)
