"""Offline EKF motion-model analysis on the port (`vslam_tpu_torch`; the same
filter run as `examples/ekf_motion_analysis.py`).

Simulates a smoothly varying SE(3) twist, feeds noisy velocity-twist
measurements to the constant-velocity EKF (`kalman.ekf_se3`) on the chosen
device, and prints the raw and filtered velocity RMSE. Given an output
path it also plots filtered against raw velocity estimates (matplotlib,
imported only then).

Usage: python examples/ekf_motion_analysis_torch.py [out.png] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vslam_tpu_torch.core.device import resolve
from vslam_tpu_torch.kalman import ekf_se3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_path", nargs="?", default=None, help="write the velocity plot here (PNG)")
    ap.add_argument("--device", default="cuda", help="torch device to filter on (default cuda)")
    args = ap.parse_args(argv)
    device = resolve(args.device)

    rng = np.random.default_rng(0)
    dt = 1.0 / 30.0
    n = 300

    # ground truth: smoothly varying twist
    t = np.arange(n) * dt
    v_true = np.stack(
        [
            0.3 * np.sin(0.8 * t),
            0.1 * np.cos(1.1 * t),
            0.2 * np.sin(0.5 * t + 1.0),
            0.05 * np.sin(0.9 * t),
            0.04 * np.cos(0.7 * t),
            0.06 * np.sin(1.3 * t),
        ],
        axis=1,
    )
    noise = rng.normal(0, 0.05, v_true.shape)
    v_meas = v_true + noise

    state = ekf_se3.init(process_noise=5e-3, device=device)
    R = torch.eye(6, device=device) * (0.05**2)
    z = torch.as_tensor(v_meas, dtype=torch.float32, device=device)
    filtered = []
    for i in range(n):
        state, _ = ekf_se3.predict(state, dt)
        state = ekf_se3.update(state, z[i], R)
        filtered.append(state.velocity)
    v_filt = torch.stack(filtered).cpu().numpy().astype(np.float64)  # one fetch

    raw_rmse = np.sqrt(np.mean((v_meas - v_true) ** 2))
    filt_rmse = np.sqrt(np.mean((v_filt - v_true) ** 2))
    print(f"velocity RMSE raw {raw_rmse:.4f} -> filtered {filt_rmse:.4f}")

    if args.out_path:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(3, 2, figsize=(12, 8), sharex=True)
        names = ["vx", "vy", "vz", "wx", "wy", "wz"]
        for k, ax in enumerate(axes.ravel()):
            ax.plot(t, v_meas[:, k], ".", ms=1.5, alpha=0.4, label="measured")
            ax.plot(t, v_true[:, k], "k-", lw=1, label="truth")
            ax.plot(t, v_filt[:, k], "-", lw=1.2, label="EKF")
            ax.set_ylabel(names[k])
        axes[0, 0].legend(fontsize=8)
        fig.suptitle("Constant-velocity SE(3) EKF: velocity filtering")
        fig.tight_layout()
        fig.savefig(args.out_path, dpi=110)
        print("wrote", args.out_path)


if __name__ == "__main__":
    main()
