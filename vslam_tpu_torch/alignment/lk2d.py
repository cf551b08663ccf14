"""2-D Lucas-Kanade: optical-flow (translation) and affine warps,
inverse-compositional and forward-additive.

Port of `vslam_tpu.alignment.lk2d` (the reference's WarpAffine /
WarpOpticalFlow, `lukas_kanade/src/Warp.cpp:23-103`, and ForwardAdditive,
`ForwardAdditive.cpp`), on the framework's batched Gauss-Newton solver.
Warp parameterizations match the reference:

- optical flow: 2 params (tx, ty); W(u,v) = (u+tx, v+ty); J = I_2
- affine: 6 params; W = [[1+p0, p2, p4], [p1, 1+p3, p5]] (u,v,1)^T;
  J = [[u-cx, 0, v-cy, 0, 1, 0], [0, u-cx, 0, v-cy, 0, 1]]
  (centred at the principal point, Warp.cpp:50-55)

IC mode precomputes steepest-descent rows from the template gradients and
composes W <- W . W(dx)^-1; FA mode rebuilds J each iteration from the
warped image gradients and adds the step, with r = T - I(W(x)) (the
opposite sign of IC's). The affine step comes out in the centred
Jacobian's parameters and is mapped to the warp's own (about the origin)
before either update; the JAX function applies it unmapped, which moves
the translation by the linear step times the centre and stalls at
480x640. Images are (H, W) for one problem or (B, H, W) for
B; the result then has the same leading axes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core import image as img_ops
from ..solvers import loss as loss_mod
from ..solvers.gauss_newton import SolverConfig, SolverResult, solve_gauss_newton
from ..solvers.normal_equations import NormalEquations
from ..utils.tree import tree_map

__all__ = ["Lk2dConfig", "align_optical_flow", "align_affine"]


@dataclasses.dataclass(frozen=True)
class Lk2dConfig:
    min_gradient: float = 0.0
    solver: SolverConfig = SolverConfig(max_iterations=50, min_step_size=1e-7)
    loss: loss_mod.LossConfig = loss_mod.LossConfig("None")
    method: str = "inverse_compositional"  # or "forward_additive"


def _affine_matrix(p: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) warp matrices from (B, 6) params (Warp.cpp:60-66 toMat)."""
    one, zero = torch.ones_like(p[:, 0]), torch.zeros_like(p[:, 0])
    return torch.stack([torch.stack([1.0 + p[:, 0], p[:, 2], p[:, 4]], -1),
                        torch.stack([p[:, 1], 1.0 + p[:, 3], p[:, 5]], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def _affine_params(Wm: torch.Tensor) -> torch.Tensor:
    return torch.stack([Wm[:, 0, 0] - 1.0, Wm[:, 1, 0], Wm[:, 0, 1], Wm[:, 1, 1] - 1.0, Wm[:, 0, 2],
                        Wm[:, 1, 2]], -1)


def _uncentred(dx: torch.Tensor, cx: float, cy: float) -> torch.Tensor:
    """A step of the centred parameters (the warp Jacobian's, about (cx,
    cy)) as a step of the warp's own, about the origin: the same linear
    part, the translation less that part applied to the centre."""
    return torch.cat([dx[:, :4], dx[:, 4:5] - dx[:, 0:1] * cx - dx[:, 2:3] * cy,
                      dx[:, 5:6] - dx[:, 1:2] * cx - dx[:, 3:4] * cy], -1)


def _gradients(img: torch.Tensor):
    blurred = img_ops.gaussian_blur_3x3(img)
    return img_ops.sobel_x(blurred) / 8.0, img_ops.sobel_y(blurred) / 8.0


def _masked_ne(J, r, vis, interest, loss_cfg, n):
    """Weighted NE over the visible points; a robust loss scales over the
    whole interest set (r = 0 where a point is not visible now), as the
    SE(3) path does (InverseCompositional.cpp:105-137)."""
    if loss_cfg.function != "None":
        scale = loss_mod.compute_scale(loss_cfg, r, interest)
        w = loss_mod.compute_weights(loss_cfg, (r - scale.offset[..., None]) / scale.scale[..., None])
        w = torch.where(vis, w, torch.zeros_like(w))
    else:
        w = vis.to(r.dtype)
    Jw = J * w[..., None]
    A = Jw.transpose(-1, -2) @ J
    b = (Jw.transpose(-1, -2) @ r[..., None])[..., 0]
    chi2 = (w * r * r).sum(-1)
    inv_n = torch.where(n > 1, 1.0 / torch.clamp(n, min=1.0), torch.ones_like(n))
    return NormalEquations(A * inv_n[:, None, None], b * inv_n[:, None], chi2 * inv_n, n)


class _Problem:
    """The template side of a 2-D problem: (B, H, W) images flattened to
    (B, P) rows, the interest mask and the template gradients."""

    def __init__(self, templ, image, cfg: Lk2dConfig):
        self.H, self.W = templ.shape[-2:]
        self.B = templ.shape[0]
        self.image = image
        self.dTx, self.dTy = _gradients(templ)
        ys = torch.arange(self.H, dtype=templ.dtype, device=templ.device)[:, None].expand(self.H, self.W)
        xs = torch.arange(self.W, dtype=templ.dtype, device=templ.device)[None, :].expand(self.H, self.W)
        self.xs, self.ys = xs.reshape(1, -1), ys.reshape(1, -1)
        g = torch.sqrt(self.dTx * self.dTx + self.dTy * self.dTy)
        self.mask = (g >= cfg.min_gradient).reshape(self.B, -1)
        self.n = self.mask.sum(-1).to(templ.dtype)
        self.templ = templ.reshape(self.B, -1)
        self.cfg = cfg
        if cfg.method != "inverse_compositional":
            self.dIx, self.dIy = _gradients(image)

    def visible(self, u, v):
        vis = self.mask & (u > 1) & (u < self.W - 1) & (v > 1) & (v < self.H - 1)
        return vis, torch.where(vis, u, torch.zeros_like(u)), torch.where(vis, v, torch.zeros_like(v))

    def ne_ic(self, J, u, v):
        vis, us, vs = self.visible(u, v)
        iw = img_ops.bilinear_sample(self.image, us, vs)
        r = torch.where(vis, iw - self.templ, torch.zeros_like(iw))
        return _masked_ne(J, r, vis, self.mask, self.cfg.loss, self.n)

    def ne_fa(self, rows, u, v):
        """FA: J rebuilt from the image gradients at the warped points."""
        vis, us, vs = self.visible(u, v)
        gx = img_ops.bilinear_sample(self.dIx, us, vs)
        gy = img_ops.bilinear_sample(self.dIy, us, vs)
        J = rows(gx, gy)
        J = torch.where(vis[..., None], J, torch.zeros_like(J))
        iw = img_ops.bilinear_sample(self.image, us, vs)
        r = torch.where(vis, self.templ - iw, torch.zeros_like(iw))  # FA residual T - I(W)
        return _masked_ne(J, r, vis, self.mask, self.cfg.loss, self.n)


def _solve(templ, image, x0, n_params, cfg, make):
    """Batch the inputs, build (compute_ne, update) with ``make(problem)``,
    solve, and drop the batch axis again for one problem."""
    unbatched = templ.dim() == 2
    if unbatched:
        templ, image = templ[None], image[None]
        x0 = None if x0 is None else x0[None]
    prob = _Problem(templ, image, cfg)
    if x0 is None:
        x0 = torch.zeros(prob.B, n_params, dtype=templ.dtype, device=templ.device)
    compute_ne, update = make(prob)
    res = solve_gauss_newton(compute_ne, update, x0, n_params=n_params, config=cfg.solver)
    if unbatched:
        res = res._replace(**{k: tree_map(lambda a: a[0], v) for k, v in res._asdict().items() if v is not None})
    return res.x, res


def align_optical_flow(templ: torch.Tensor, image: torch.Tensor, x0: Optional[torch.Tensor] = None,
                       cfg: Lk2dConfig = Lk2dConfig()) -> Tuple[torch.Tensor, SolverResult]:
    """The translation that warps ``templ`` into ``image``. Returns (flow
    (..., 2), solver result)."""

    def make(prob: _Problem):
        if cfg.method == "inverse_compositional":
            J = torch.stack([prob.dTx.reshape(prob.B, -1), prob.dTy.reshape(prob.B, -1)], dim=-1)
            J = torch.where(prob.mask[..., None], J, torch.zeros_like(J))
            # compositional for a pure translation: subtract
            return (lambda p: prob.ne_ic(J, prob.xs + p[:, :1], prob.ys + p[:, 1:])), (lambda p, dx: p - dx)
        return ((lambda p: prob.ne_fa(lambda gx, gy: torch.stack([gx, gy], dim=-1),
                                      prob.xs + p[:, :1], prob.ys + p[:, 1:])),
                (lambda p, dx: p + dx))

    return _solve(templ, image, x0, 2, cfg, make)


def align_affine(templ: torch.Tensor, image: torch.Tensor, x0: Optional[torch.Tensor] = None,
                 cfg: Lk2dConfig = Lk2dConfig()) -> Tuple[torch.Tensor, SolverResult]:
    """The 6-parameter affine warp W(p) with I(W(p)(u, v)) ~= T(u, v).
    Returns (params (..., 6), solver result)."""

    def make(prob: _Problem):
        cx, cy = prob.W / 2.0, prob.H / 2.0
        uc = prob.xs - cx  # the warp Jacobian centred at the principal point (Warp.cpp:50-55)
        vc = prob.ys - cy

        def rows(gx, gy):
            return torch.stack([gx * uc, gy * uc, gx * vc, gy * vc, gx, gy], dim=-1)

        def warp_uv(p):
            Wm = _affine_matrix(p)
            u = Wm[:, 0, 0, None] * prob.xs + Wm[:, 0, 1, None] * prob.ys + Wm[:, 0, 2, None]
            v = Wm[:, 1, 0, None] * prob.xs + Wm[:, 1, 1, None] * prob.ys + Wm[:, 1, 2, None]
            return u, v

        if cfg.method == "inverse_compositional":
            # steepest-descent rows from the template gradients, once
            # (InverseCompositional.cpp:50-59)
            J = rows(prob.dTx.reshape(prob.B, -1), prob.dTy.reshape(prob.B, -1))
            J = torch.where(prob.mask[..., None], J, torch.zeros_like(J))

            def update(p, dx):
                # W(p) <- W(p) . W(dx)^-1, the exact composition
                return _affine_params(_affine_matrix(p) @ torch.linalg.inv(_affine_matrix(_uncentred(dx, cx, cy))))

            return (lambda p: prob.ne_ic(J, *warp_uv(p))), update
        return (lambda p: prob.ne_fa(rows, *warp_uv(p))), (lambda p, dx: p + _uncentred(dx, cx, cy))

    return _solve(templ, image, x0, 6, cfg, make)
