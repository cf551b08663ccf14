"""Trajectory and RPE plots (reference `script/vslam_evaluation/plot/
{plot_traj,plot_rpe}.py`): xy top-down + z-over-time trajectory comparison
and per-pair RPE curves, saved as PNG (headless backend).

A copy of `vslam_tpu.eval.plot` (numpy and matplotlib), except that
matplotlib is imported by each plotting function, so the module imports
without it."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..core import lie_np
from . import metrics

__all__ = ["plot_trajectory", "plot_rpe", "plot_gauss_newton", "plot_histogram", "install_convergence_renderer"]


def _pyplot():
    """matplotlib's pyplot on the headless Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectory(
    gt: Optional[Dict[float, np.ndarray]],
    est: Dict[float, np.ndarray],
    out_path: str,
    title: str = "trajectory",
) -> None:
    """Top-down xy plus z(t), estimated vs ground truth (cam->world poses)."""
    plt = _pyplot()
    fig, (ax_xy, ax_z) = plt.subplots(1, 2, figsize=(11, 4.5))
    for name, traj, style in [("estimate", est, "-"), ("ground truth", gt, "--")]:
        if not traj:
            continue
        ts = sorted(traj.keys())
        P = np.stack([traj[t][:3, 3] for t in ts])
        ax_xy.plot(P[:, 0], P[:, 1], style, label=name, linewidth=1.2)
        ax_z.plot(np.asarray(ts) - ts[0], P[:, 2], style, label=name, linewidth=1.2)
    ax_xy.set_xlabel("x [m]")
    ax_xy.set_ylabel("y [m]")
    ax_xy.axis("equal")
    ax_xy.legend()
    ax_xy.set_title(title)
    ax_z.set_xlabel("t [s]")
    ax_z.set_ylabel("z [m]")
    ax_z.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_gauss_newton(data: Dict[str, np.ndarray], out_path: str) -> None:
    """Solver convergence plot: chi2 and step size per iteration (reference
    vis::PlotGaussNewton, visuals.h:71-100, emitted via
    LOG_PLT("SolverGN") at GaussNewton.cpp:100).

    ``data`` holds "chi2" and "step_size" arrays, either (iters,) for one
    solve or (levels, iters) for a coarse-to-fine stack; NaN entries (beyond
    the converged iteration) are trimmed per curve.
    """
    chi2 = np.atleast_2d(np.asarray(data["chi2"], np.float64))
    step = np.atleast_2d(np.asarray(data["step_size"], np.float64))
    plt = _pyplot()
    fig, (a1, a2) = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
    for lvl in range(chi2.shape[0]):
        n = int(np.sum(np.isfinite(chi2[lvl])))
        label = f"level {lvl}" if chi2.shape[0] > 1 else "chi2"
        a1.plot(np.arange(n), chi2[lvl, :n], ".-", markersize=3, label=label)
        a2.plot(np.arange(n), step[lvl, :n], ".-", markersize=3, label=label)
    a1.set_ylabel(r"$\chi^2$")
    a1.set_yscale("log")
    a1.legend(fontsize=8)
    a2.set_ylabel(r"$\|\Delta x\|$")
    a2.set_yscale("log")
    a2.set_xlabel("iteration")
    fig.suptitle("Gauss-Newton convergence")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_histogram(values: np.ndarray, out_path: str, title: str = "Histogram",
                   bins: int = 50, xlabel: str = "value") -> None:
    """Histogram drawable (reference vis::Histogram, visuals.h:34-70 — used
    there for residual/weight distributions). Non-finite entries dropped."""
    v = np.asarray(values, np.float64).reshape(-1)
    v = v[np.isfinite(v)]
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.hist(v, bins=bins, color="tab:blue", alpha=0.85)
    ax.set_xlabel(xlabel)
    ax.set_ylabel("count")
    ax.set_title(f"{title} (n={len(v)})")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def install_convergence_renderer(name: str = "SolverGN") -> None:
    """Attach the convergence-plot renderer to a LOG_PLT sink so enabled
    plot logs also save PNGs next to the .npz payloads."""
    from ..utils.log import log_plt

    log_plt(name).renderer = plot_gauss_newton


def plot_rpe(
    gt: Dict[float, np.ndarray],
    est: Dict[float, np.ndarray],
    out_path: str,
    fixed_delta: float = 1.0,
) -> None:
    """Per-pair translational/rotational RPE over time."""
    ts_g = sorted(gt.keys())
    ts_e = sorted(est.keys())
    matches = metrics.associate(ts_g, ts_e)
    te = np.asarray([ts_e[ib] for _, ib in matches])
    tg = [ts_g[ia] for ia, _ in matches]
    t_err, r_err, stamps = [], [], []
    for i in range(len(matches)):
        target = te[i] + fixed_delta
        j = int(np.searchsorted(te, target))
        if j >= len(matches):
            continue
        if j > 0 and abs(te[j - 1] - target) < abs(te[j] - target):
            j -= 1
        if abs(te[j] - target) > 0.2 * fixed_delta:
            continue
        rel_e = lie_np.inv(est[te[i]]) @ est[te[j]]
        rel_g = lie_np.inv(gt[tg[i]]) @ gt[tg[j]]
        E = lie_np.inv(rel_g) @ rel_e
        t_err.append(np.linalg.norm(E[:3, 3]))
        r_err.append(np.linalg.norm(lie_np.matrix_to_rotvec(E[:3, :3])))
        stamps.append(te[i] - te[0])
    plt = _pyplot()
    fig, (a1, a2) = plt.subplots(2, 1, figsize=(9, 6), sharex=True)
    a1.plot(stamps, t_err, ".-", markersize=3, linewidth=0.8)
    a1.set_ylabel("trans RPE [m]")
    a2.plot(stamps, r_err, ".-", markersize=3, linewidth=0.8)
    a2.set_ylabel("rot RPE [rad]")
    a2.set_xlabel("t [s]")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
