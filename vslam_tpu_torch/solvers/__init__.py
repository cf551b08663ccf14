"""Nonlinear least-squares engine (port of `vslam_tpu.solvers`)."""

from . import gauss_newton, linalg6, loss, normal_equations
from .gauss_newton import SolverConfig, SolverResult, solve_gauss_newton, solve_levenberg_marquardt
from .loss import LossConfig, Scale, compute_scale, compute_weights
from .normal_equations import NormalEquations

__all__ = [
    "gauss_newton",
    "linalg6",
    "loss",
    "normal_equations",
    "SolverConfig",
    "SolverResult",
    "solve_gauss_newton",
    "solve_levenberg_marquardt",
    "LossConfig",
    "Scale",
    "compute_scale",
    "compute_weights",
    "NormalEquations",
]
