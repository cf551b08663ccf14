"""Epipolar geometry demo on a synthetic stereo pair, on the port
(`vslam_tpu_torch`; the same check as `examples/epipolar_lines.py`).

The fundamental matrix comes from `features.matcher.fundamental_matrix` on
the chosen device (the same F the matcher's epipolar distance uses,
reference `Matcher.cpp:59-72`); ground-truth correspondences come from the
rendered depth, and the point-to-epipolar-line distance of each is
printed — near zero for correct geometry.

Run: python examples/epipolar_lines_torch.py [--plot out.png] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vslam_tpu_torch.core import lie_np
from vslam_tpu_torch.core.device import resolve
from vslam_tpu_torch.features import matcher
from vslam_tpu_torch.io import synthetic

H, W, FX = 240, 320, 260.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plot", default=None)
    ap.add_argument("--device", default="cuda", help="torch device for F (default cuda)")
    args = ap.parse_args(argv)
    device = resolve(args.device)

    K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    pose0 = np.eye(4)
    xi = np.array([0.08, -0.03, 0.05, 0.02, -0.04, 0.01])
    pose1 = lie_np.exp(xi) @ pose0
    img0, depth0 = synthetic.render(K, pose0, (H, W))
    img1, _ = synthetic.render(K, pose1, (H, W))

    # ground-truth correspondences: backproject a pixel grid via depth0 and
    # reproject into view 1 (keeps the demo detector-independent)
    vv, uu = np.mgrid[20:H - 20:24, 20:W - 20:24]
    uv0 = np.stack([uu.ravel(), vv.ravel()], axis=1).astype(np.float64)
    z = depth0[uv0[:, 1].astype(int), uv0[:, 0].astype(int)]
    p_cam0 = np.linalg.inv(K) @ np.concatenate([uv0.T, np.ones((1, len(uv0)))]) * z
    p_world = lie_np.transform(lie_np.inv(pose0), p_cam0.T)
    p_cam1 = lie_np.transform(pose1, p_world)
    uv1_h = (K @ p_cam1.T).T
    vis = p_cam1[:, 2] > 0.1
    uv1 = uv1_h[:, :2] / uv1_h[:, 2:3]
    inb = vis & (uv1[:, 0] > 0) & (uv1[:, 0] < W - 1) & (uv1[:, 1] > 0) & (uv1[:, 1] < H - 1)
    uv0, uv1 = uv0[inb], uv1[inb]

    # F from the relative pose (matcher's epipolar-distance geometry)
    rel = pose1 @ lie_np.inv(pose0)
    K_t = torch.as_tensor(K, dtype=torch.float32, device=device)
    F = matcher.fundamental_matrix(K_t, torch.as_tensor(rel, dtype=torch.float32, device=device), K_t)
    F = F.cpu().numpy()

    x0 = np.concatenate([uv0, np.ones((len(uv0), 1))], axis=1)
    x1 = np.concatenate([uv1, np.ones((len(uv1), 1))], axis=1)
    lines = x0 @ F.T  # epipolar line in view 1 for each view-0 point
    # normalized point-line distance |x1 . l| / ||l_xy||
    d = np.abs(np.sum(x1 * lines, axis=1)) / np.linalg.norm(lines[:, :2], axis=1)
    print(f"{len(uv0)} correspondences; epipolar distance: "
          f"mean {d.mean():.4f} px, max {d.max():.4f} px")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, (a0, a1) = plt.subplots(1, 2, figsize=(12, 5))
        a0.imshow(img0, cmap="gray")
        a0.scatter(uv0[:, 0], uv0[:, 1], s=8, c="tab:orange")
        a0.set_title("view 0 points")
        a1.imshow(img1, cmap="gray")
        xs = np.array([0.0, W - 1.0])
        for l in lines[:: max(1, len(lines) // 40)]:
            if abs(l[1]) > 1e-9:
                a1.plot(xs, (-l[2] - l[0] * xs) / l[1], lw=0.5, c="tab:blue")
        a1.scatter(uv1[:, 0], uv1[:, 1], s=8, c="tab:orange")
        a1.set_xlim(0, W - 1)
        a1.set_ylim(H - 1, 0)
        a1.set_title("view 1: epipolar lines through matches")
        fig.tight_layout()
        fig.savefig(args.plot, dpi=120)
        print(f"wrote {args.plot}")


if __name__ == "__main__":
    main()
