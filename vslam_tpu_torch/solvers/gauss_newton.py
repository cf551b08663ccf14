"""Gauss-Newton and Levenberg-Marquardt over a batch of independent problems.

Port of `vslam_tpu.solvers.gauss_newton`. `solve_gauss_newton` keeps the
guard/rollback semantics of reference `GaussNewton.cpp:33-102`:

  * stop if nConstraints < nParameters
  * stop if log|det(A)| is non-finite or below log(1e-6)
  * stop if chi2 increased; x rolls back to the pre-iteration value
  * converged if an iteration was accepted before and |dx| < minStepSize,
    |max(b)| < minGradient (max(b), not max|b|) or |dChi2| < minReduction,
    or (f32 extension) |dChi2| < min_relative_reduction * |chi2|
  * NaN step: restore the pre-iteration x and stop

The JAX version runs one problem per `lax.while_loop` under `vmap`. Here the
leading axis B of every tensor is the batch, and a per-problem ``done``
mask freezes each problem at its own exit, which is what `vmap` of the
while loop does. The loop itself runs until every problem is done: the
host reads one flag an iteration. `solve_levenberg_marquardt` (an
extension of the JAX package's; the reference ships GN only) is built the
same way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from ..utils.tree import tree_map
from .linalg6 import cholesky_logdet_solve, cholesky_solve
from .normal_equations import NormalEquations

__all__ = ["SolverConfig", "SolverResult", "solve_gauss_newton", "solve_levenberg_marquardt"]

_LOG_MIN_DET = torch.log(torch.tensor(1e-6, dtype=torch.float32)).item()


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Mirrors the reference GaussNewton ctor (GaussNewton.cpp:25-31);
    minGradient and minReduction default to minStepSize."""

    max_iterations: int = 100
    min_step_size: float = 1e-11
    min_gradient: float | None = None
    min_reduction: float | None = None
    # f32 extension: also stop when the chi2 improvement falls below this
    # fraction of the current chi2. None disables.
    min_relative_reduction: float | None = None

    @property
    def _min_gradient(self) -> float:
        return self.min_step_size if self.min_gradient is None else self.min_gradient

    @property
    def _min_reduction(self) -> float:
        return self.min_step_size if self.min_reduction is None else self.min_reduction


class SolverResult(NamedTuple):
    x: Any  # final optimization state, leaves (B, ...)
    A: torch.Tensor  # (B, N, N) last accepted normal-equation matrix
    b: torch.Tensor  # (B, N)
    chi2: torch.Tensor  # (B,)
    iterations: torch.Tensor  # (B,) int32 accepted iterations
    valid: torch.Tensor  # (B,) bool: at least one iteration was accepted
    chi2_history: torch.Tensor  # (B, max_iterations), NaN past the last evaluated
    step_history: torch.Tensor  # (B, max_iterations)
    # (B, max_iterations, K) encoded state at which each evaluated
    # iteration's NE was taken, NaN past the last (only with encode_x)
    x_history: Any = None


def _select(pred: torch.Tensor, a, b):
    """Leaf-wise where(pred, a, b) with pred (B,) broadcast over each leaf."""
    return tree_map(lambda u, v: torch.where(pred.view(-1, *([1] * (u.dim() - 1))), u, v), a, b)


def gn_decision(ne: NormalEquations, dx, logdet, chi2_prev, pushed, config: SolverConfig, n_params=6):
    """One iteration's guard and convergence logic, batched over (B,).

    Returns (step, accepted, done); shared by the gather path and the plain
    version of the whole-level kernel so the two cannot drift apart."""
    stop_constraints = ne.n < n_params
    stop_det = ~torch.isfinite(logdet) | (logdet < _LOG_MIN_DET)
    chi2_increased = (pushed > 0) & (ne.chi2 > chi2_prev)
    abort = stop_constraints | stop_det | chi2_increased
    # sequential sum of squares: the order the CUDA kernel uses
    step = torch.sqrt(sum(dx[..., k] * dx[..., k] for k in range(dx.shape[-1])))
    nan_step = ~torch.isfinite(step)

    d_chi2 = torch.abs(ne.chi2 - chi2_prev)
    b_max = torch.max(ne.b, dim=-1).values
    converged = (pushed > 0) & (
        (step < config.min_step_size)
        | (torch.abs(b_max) < config._min_gradient)
        | (d_chi2 < config._min_reduction)
    )
    if config.min_relative_reduction is not None:
        converged = converged | (
            (pushed > 0) & (d_chi2 < config.min_relative_reduction * torch.abs(ne.chi2))
        )
    accepted = ~abort & ~nan_step
    return step, accepted, abort | nan_step | converged


def solve_gauss_newton(
    compute_ne: Callable[[Any], NormalEquations],
    update_x: Callable[[Any, torch.Tensor], Any],
    x0: Any,
    n_params: int,
    config: SolverConfig = SolverConfig(),
    encode_x: Callable[[Any], torch.Tensor] | None = None,
) -> SolverResult:
    """Batched GN: ``compute_ne(x)`` returns NormalEquations with leading
    axis B; ``update_x(x, dx)`` applies a (B, n_params) step. ``encode_x``,
    when given, maps the state to a (B, K) vector recorded per evaluated
    iteration (`SolverResult.x_history`, for the visual-log replay)."""
    ne0 = compute_ne(x0)
    A0 = ne0.A
    B, dtype, device = A0.shape[0], A0.dtype, A0.device
    x = x0
    chi2_prev = torch.full((B,), float("inf"), dtype=dtype, device=device)
    A_last = torch.eye(n_params, dtype=dtype, device=device).expand(B, n_params, n_params).clone()
    b_last = torch.zeros(B, n_params, dtype=dtype, device=device)
    pushed = torch.zeros(B, dtype=torch.int32, device=device)
    done = torch.zeros(B, dtype=torch.bool, device=device)
    chi2_hist = torch.full((B, config.max_iterations), float("nan"), dtype=dtype, device=device)
    step_hist = torch.full_like(chi2_hist, float("nan"))
    x_hist = None
    if encode_x is not None:
        K = encode_x(x0).shape[-1]
        x_hist = torch.full((B, config.max_iterations, K), float("nan"), dtype=dtype, device=device)

    ne = ne0
    for i in range(config.max_iterations):
        if i > 0:
            if bool(done.all()):
                break
            ne = compute_ne(x)
        live = ~done
        dx, logdet = cholesky_logdet_solve(ne.A, ne.b)
        step, accepted, stop = gn_decision(ne, dx, logdet, chi2_prev, pushed, config, n_params)
        if x_hist is not None:
            x_hist[:, i] = torch.where(live[:, None], encode_x(x), x_hist[:, i])
        x_new = update_x(x, dx)
        take = live & accepted
        x = _select(take, x_new, x)
        A_last = torch.where(take[:, None, None], ne.A, A_last)
        b_last = torch.where(take[:, None], ne.b, b_last)
        chi2_prev = torch.where(take, ne.chi2, chi2_prev)
        pushed = pushed + take.to(torch.int32)
        chi2_hist[:, i] = torch.where(live, ne.chi2, chi2_hist[:, i])
        step_hist[:, i] = torch.where(live, step, step_hist[:, i])
        done = done | stop
    return SolverResult(
        x=x,
        A=A_last,
        b=b_last,
        chi2=chi2_prev,
        iterations=pushed,
        valid=pushed > 0,
        chi2_history=chi2_hist,
        step_history=step_hist,
        x_history=x_hist,
    )


def solve_levenberg_marquardt(
    compute_ne: Callable[[Any], NormalEquations],
    update_x: Callable[[Any, torch.Tensor], Any],
    x0: Any,
    n_params: int,
    config: SolverConfig = SolverConfig(),
    lambda0: float = 1e-3,
    lambda_up: float = 10.0,
    lambda_down: float = 0.1,
    max_lambda: float = 1e6,
) -> SolverResult:
    """Batched Levenberg-Marquardt with multiplicative damping on diag(A),
    the JAX function's schedule: each iteration solves (A + lam diag A) dx
    = b at the carried NE and evaluates the trial point once; it is taken
    when its chi2 is lower, finite and the problem has enough constraints,
    and lam falls by ``lambda_down`` (>= 1e-12), else rises by ``lambda_up``
    (<= ``max_lambda``). A problem stops on too few constraints, an
    accepted step below ``min_step_size``, or a rejected trial at
    ``max_lambda``. Returns the NE at the final x; ``iterations`` counts the
    accepted steps and the histories hold every trial's chi2 and step."""
    ne = compute_ne(x0)
    B, dtype, device = ne.A.shape[0], ne.A.dtype, ne.A.device
    x = x0
    lam = torch.full((B,), lambda0, dtype=dtype, device=device)
    pushed = torch.zeros(B, dtype=torch.int32, device=device)
    done = torch.zeros(B, dtype=torch.bool, device=device)
    chi2_hist = torch.full((B, config.max_iterations), float("nan"), dtype=dtype, device=device)
    step_hist = torch.full_like(chi2_hist, float("nan"))
    for i in range(config.max_iterations):
        if i > 0 and bool(done.all()):
            break
        live = ~done
        stop_constraints = ne.n < n_params
        damped = ne.A + lam[:, None, None] * torch.diag_embed(torch.diagonal(ne.A, dim1=-2, dim2=-1))
        dx = cholesky_solve(damped, ne.b)
        x_new = update_x(x, dx)
        ne_new = compute_ne(x_new)
        step = torch.linalg.vector_norm(dx, dim=-1)
        nan_step = ~torch.isfinite(step) | ~torch.isfinite(ne_new.chi2)
        accept = (ne_new.chi2 < ne.chi2) & ~nan_step & ~stop_constraints
        take = live & accept
        x = _select(take, x_new, x)
        ne = _select(take, ne_new, ne)
        lam_next = torch.where(accept, torch.clamp(lam * lambda_down, min=1e-12),
                               torch.clamp(lam * lambda_up, max=max_lambda))
        stop = stop_constraints | (accept & (step < config.min_step_size)) | (~accept & (lam >= max_lambda))
        lam = torch.where(live, lam_next, lam)
        pushed = pushed + take.to(torch.int32)
        chi2_hist[:, i] = torch.where(live, ne_new.chi2, chi2_hist[:, i])
        step_hist[:, i] = torch.where(live, step, step_hist[:, i])
        done = done | stop
    return SolverResult(
        x=x,
        A=ne.A,
        b=ne.b,
        chi2=ne.chi2,
        iterations=pushed,
        valid=pushed > 0,
        chi2_history=chi2_hist,
        step_history=step_hist,
    )
