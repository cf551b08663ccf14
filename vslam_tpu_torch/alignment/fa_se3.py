"""Forward-additive SE(3) photometric alignment, the second photometric
baseline beside the inverse-compositional aligner (`ic.py`).

Port of `vslam_tpu.alignment.fa_se3` (the role of the reference's
`RgbdAlignmentOpenCv`, RgbdAlignmentOpenCv.cpp:42-59, with the SE(3) warp of
`ForwardAdditive.cpp:51-90`). Each iteration rebuilds the Jacobian from the
current image's gradients at the warped points and updates the transform
on the left:

    p' = T p_ref;  (u,v) = proj(p');  g = [dIx, dIy](u, v)
    J = g . Jproj(p')          (2x6 analytic, Warp.cpp:166-201)
    r = T(x) - I(u, v)         (FA residual sign, ForwardAdditive.cpp:60)
    solve (JᵀWJ) dx = JᵀWr;  T <- exp(dx) . T

The JAX version aligns one pair inside a `lax.while_loop`; here `align_fa`
takes frames with a leading pair axis B (or none, for one pair) and the
batched Gauss-Newton freezes each pair at its own exit. No Pallas kernel is
on this path: it is plain PyTorch, as it is XLA in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..core import camera as cam_mod
from ..core import image as img_ops
from ..core import lie_np, se3
from ..core.device import resolve
from ..core.frame import Frame
from ..core.se3 import SE3
from ..solvers import loss as loss_mod
from ..solvers.gauss_newton import SolverConfig, solve_gauss_newton
from ..solvers.linalg6 import inv_psd
from ..solvers.normal_equations import NormalEquations
from ..utils.tree import tree_map
from .ic import _projection_jacobian, precompute_level

__all__ = ["FaAlignmentConfig", "align_fa", "RgbdAlignerFa"]


@dataclasses.dataclass(frozen=True)
class FaAlignmentConfig:
    min_gradient: float = 30.0
    solver: SolverConfig = SolverConfig(max_iterations=50, min_step_size=1e-7)
    loss: loss_mod.LossConfig = loss_mod.LossConfig("None")
    max_points: int = 16384


def _level_fa(data, image, dIx, dIy, cam_cur, rel0: SE3, cfg: FaAlignmentConfig):
    """One pyramid level of forward-additive GN over the full transforms T
    (B,): level data (B, P, ...), images (B, H, W), camera leaves (B,)."""
    H, W = image.shape[-2:]
    cam = cam_mod.expand(cam_cur, 2)

    def compute_ne(T: SE3) -> NormalEquations:
        p = se3.transform_points(SE3(T.R[:, None], T.t[:, None]), data.pcl)
        uv, zok = cam_mod.project(cam, p)
        u, v = uv[..., 0], uv[..., 1]
        vis = data.mask & zok & (u > 1) & (u < W - 1) & (v > 1) & (v < H - 1)
        us = torch.where(vis, u, torch.zeros_like(u))
        vs = torch.where(vis, v, torch.zeros_like(v))
        gx = img_ops.bilinear_sample(dIx, us, vs)
        gy = img_ops.bilinear_sample(dIy, us, vs)
        Jw = _projection_jacobian(p, cam.fx, cam.fy)  # (B, P, 2, 6)
        J = gx[..., None] * Jw[..., 0, :] + gy[..., None] * Jw[..., 1, :]
        J = torch.where(vis[..., None], J, torch.zeros_like(J))
        iw = img_ops.bilinear_sample(image, us, vs)
        r = torch.where(vis, data.templ - iw, torch.zeros_like(iw))  # FA sign: T - I(W)
        if cfg.loss.function != "None":
            scale = loss_mod.compute_scale(cfg.loss, r, data.mask)
            w = loss_mod.compute_weights(cfg.loss, (r - scale.offset[..., None]) / scale.scale[..., None])
            w = torch.where(vis, w, torch.zeros_like(w))
        else:
            w = vis.to(r.dtype)
        Jw_ = J * w[..., None]
        A = Jw_.transpose(-1, -2) @ J
        b = (Jw_.transpose(-1, -2) @ r[..., None])[..., 0]
        chi2 = (w * r * r).sum(-1)
        n = data.n_constraints
        inv_n = torch.where(n > 1, 1.0 / torch.clamp(n, min=1.0), torch.ones_like(n))
        return NormalEquations(A * inv_n[:, None, None], b * inv_n[:, None], chi2 * inv_n, n)

    def update(T: SE3, dx: torch.Tensor) -> SE3:
        return se3.orthonormalize(se3.compose(se3.exp(dx), T))

    res = solve_gauss_newton(compute_ne, update, rel0, n_params=6, config=cfg.solver)
    return res.x, res


def align_fa(ref_frame: Frame, cur_frame: Frame, rel_init: SE3,
             cfg: FaAlignmentConfig = FaAlignmentConfig()) -> Tuple[SE3, torch.Tensor, torch.Tensor]:
    """Coarse-to-fine forward-additive alignment of ``cur_frame`` against
    ``ref_frame``. Frames carry one pair (leaves (H, W)) or a leading pair
    axis B; ``rel_init`` has the same batch shape. Returns (rel, cov (...,
    6, 6), valid (...))."""
    unbatched = ref_frame.intensity[0].dim() == 2
    if unbatched:
        ref_frame, cur_frame, rel_init = (tree_map(lambda a: a[None], x)
                                          for x in (ref_frame, cur_frame, rel_init))
    B = rel_init.t.shape[0]
    rel = rel_init
    dtype, device = cur_frame.intensity[0].dtype, cur_frame.intensity[0].device
    cov = torch.eye(6, dtype=dtype, device=device).expand(B, 6, 6)
    valid_any = torch.zeros(B, dtype=torch.bool, device=device)
    for level in range(len(ref_frame.intensity) - 1, -1, -1):
        budget = cfg.max_points >> (2 * level) if cfg.max_points else 0
        data = precompute_level(ref_frame.intensity[level], ref_frame.dIx[level], ref_frame.dIy[level],
                                ref_frame.depth[level], ref_frame.cameras[level], cfg.min_gradient,
                                max_points=budget)
        # raw 3x3 Sobel derivatives, as the reference's FA consumes
        # frame->dIx() (ForwardAdditive.cpp:60-66): their 8x gain makes each
        # step 1/8 of the true one, a damping that keeps FA stable on large
        # coarse-level motion
        rel, res = _level_fa(data, cur_frame.intensity[level], cur_frame.dIx[level], cur_frame.dIy[level],
                             cur_frame.cameras[level], rel, cfg)
        cov = torch.where(res.valid[:, None, None], inv_psd(res.A), cov)
        valid_any = valid_any | res.valid
    if unbatched:
        return SE3(rel.R[0], rel.t[0]), cov[0], valid_any[0]
    return rel, cov, valid_any


def _host_pose(rel: SE3, cov, ok, ref_pose):
    """One fetch of (rel, cov, ok), then the absolute f64 pose with the
    rotation re-orthonormalized by SVD."""
    flat = torch.cat([rel.R.reshape(9), rel.t.reshape(3), cov.reshape(36), ok.reshape(1).float()])
    flat = flat.cpu().double().numpy()
    T = np.eye(4)
    u, _, vt = np.linalg.svd(flat[:9].reshape(3, 3))
    T[:3, :3] = u @ vt
    T[:3, 3] = flat[9:12]
    return T @ ref_pose, flat[12:48].reshape(6, 6), bool(flat[48])


class RgbdAlignerFa:
    """Host-facing wrapper with the aligner interface, a drop-in second
    photometric baseline beside `RgbdAligner` (the reference wires
    RgbdAlignmentOpenCv the same way, Odometry.cpp:65-87). Frames move to
    ``device`` (CUDA unless named) for the solve."""

    def __init__(self, cfg: FaAlignmentConfig = FaAlignmentConfig(), device=None):
        self.cfg = cfg
        self.device = resolve(device)

    def align(self, ref_frames, ref_poses, cur_frame: Frame, pred_pose: np.ndarray):
        """Align ``cur_frame`` against the first reference, starting from the
        predicted pose. Returns (pose world->cam 4x4 f64, cov 6x6, ok)."""
        ref_frame, ref_pose = ref_frames[0], ref_poses[0]
        ref_frame, cur_frame = (tree_map(lambda a: a.to(self.device), f) for f in (ref_frame, cur_frame))
        rel0 = lie_np.relative(ref_pose, pred_pose)
        dtype = cur_frame.intensity[0].dtype
        rel0 = SE3(torch.as_tensor(rel0[:3, :3], dtype=dtype, device=self.device),
                   torch.as_tensor(rel0[:3, 3], dtype=dtype, device=self.device))
        return _host_pose(*align_fa(ref_frame, cur_frame, rel0, self.cfg), ref_pose)
