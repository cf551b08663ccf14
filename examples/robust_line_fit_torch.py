"""Robust line fitting with the port's loss / scaler stack (`vslam_tpu_torch`;
the same fit as `examples/robust_line_fit.py`).

IRLS with a robust weighting on a contaminated line dataset, on
`vslam_tpu_torch.solvers`: the same Gauss-Newton engine, losses and scalers
the dense aligner uses. The engine is batched, so the fit is one problem
of a batch of one.

Run: python examples/robust_line_fit_torch.py [--plot out.png] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vslam_tpu_torch.core.device import resolve
from vslam_tpu_torch.solvers import LossConfig, SolverConfig, compute_scale, compute_weights, solve_gauss_newton
from vslam_tpu_torch.solvers.normal_equations import NormalEquations


def make_data(n=100, outlier_frac=0.05, seed=7):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-100, 100, n)
    ys = 1.0 * xs + 0.0 + rng.normal(0, 2.0, n)
    out = rng.uniform(size=n) < outlier_frac
    ys = np.where(out, ys + rng.normal(0, 200.0, n), ys)
    return xs.astype(np.float32), ys.astype(np.float32), out


def fit(xs, ys, loss_name: str, device) -> np.ndarray:
    """GN over (m, c) with the port's robust weighting, on ``device``."""
    x = torch.as_tensor(xs, device=device)
    X = torch.stack([x, torch.ones_like(x)], dim=1)  # (N, 2)
    y = torch.as_tensor(ys, device=device)[None]  # (1, N): a batch of one problem
    cfg_loss = LossConfig(loss_name)
    mask = torch.ones_like(y, dtype=torch.bool)

    def compute_ne(mc):  # mc (1, 2)
        r = mc @ X.T - y
        if cfg_loss.function != "None":
            scale = compute_scale(cfg_loss, r, mask)
            w = compute_weights(cfg_loss, (r - scale.offset[:, None]) / scale.scale[:, None])
        else:
            w = torch.ones_like(r)
        Xw = X * w[..., None]  # (1, N, 2)
        return NormalEquations(Xw.transpose(-1, -2) @ X, (Xw.transpose(-1, -2) @ r[..., None])[..., 0],
                               torch.sum(w * r * r, dim=-1), mask.sum(-1).to(r.dtype))

    res = solve_gauss_newton(
        compute_ne,
        lambda mc, dx: mc - dx,
        torch.zeros(1, 2, device=device),
        2,
        SolverConfig(max_iterations=30, min_step_size=1e-8),
    )
    return res.x[0].cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plot", default=None, help="write a comparison PNG")
    ap.add_argument("--device", default="cuda", help="torch device to fit on (default cuda)")
    args = ap.parse_args(argv)
    device = resolve(args.device)

    xs, ys, outliers = make_data()
    results = {name: fit(xs, ys, name, device) for name in ["None", "Huber", "Tukey"]}
    print(f"ground truth: m=1.000 c=0.000 ({outliers.sum()} outliers / {len(xs)} pts)")
    for name, (m, c) in results.items():
        print(f"loss={name:6s}: m={m:+.4f} c={c:+.4f}")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 5))
        ax.scatter(xs[~outliers], ys[~outliers], s=8, label="inliers")
        ax.scatter(xs[outliers], ys[outliers], s=12, color="tab:red", label="outliers")
        grid = np.linspace(xs.min(), xs.max(), 2)
        for name, (m, c) in results.items():
            ax.plot(grid, m * grid + c, label=f"{name} fit")
        ax.legend()
        fig.tight_layout()
        fig.savefig(args.plot, dpi=120)
        print(f"wrote {args.plot}")


if __name__ == "__main__":
    main()
