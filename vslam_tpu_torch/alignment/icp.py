"""Dense projective ICP on depth maps, point-to-plane or point-to-point.

Port of `vslam_tpu.alignment.icp` (the role of the reference's geometric
baselines, `IterativeClosestPoint` (PCL point-to-point,
IterativeClosestPoint.cpp) and `IterativeClosestPointOcv` (cv::rgbd
ICPOdometry, point-to-plane)):

- correspondences by projective data association: transform the reference
  points, project them into the current depth map, gather the hit point and
  its normal (one gather an iteration, no KD-tree);
- point-to-plane residuals r = n . (T p - q) with a distance gate and the
  normal-compatibility gate (the reference normal rotated into the current
  frame must agree with the hit pixel's normal);
- the 6-dof Gauss-Newton solve on the same batched solver as the
  photometric aligners, coarse to fine over the depth pyramid.

Frames carry one pair (leaves (H, W)) or a leading pair axis B. Plain
PyTorch: the JAX version reaches no Pallas kernel either.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import camera as cam_mod
from ..core import lie_np, se3
from ..core.device import resolve
from ..core.frame import Frame, frame_pcl
from ..core.se3 import SE3
from ..solvers.gauss_newton import SolverConfig, solve_gauss_newton
from ..solvers.linalg6 import inv_psd
from ..solvers.normal_equations import NormalEquations
from ..utils.tree import tree_map
from .fa_se3 import _host_pose

__all__ = ["IcpConfig", "align_icp", "IcpAligner"]


@dataclasses.dataclass(frozen=True)
class IcpConfig:
    solver: SolverConfig = SolverConfig(max_iterations=30, min_step_size=1e-7)
    max_distance: float = 0.25  # gate on point-pair distance [m]
    min_cos_normal: float = 0.5  # gate on normal agreement
    coarsest_level: Optional[int] = None  # default: all levels
    # "point_to_plane": the cv::rgbd ICPOdometry formulation (default);
    # "point_to_point": the PCL IterativeClosestPoint one
    # (IterativeClosestPoint.cpp:22-108), 3 residuals per correspondence
    variant: str = "point_to_plane"


def _normals_from_depth(points: torch.Tensor, valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel normals from central differences of the organized point
    cloud (..., H, W, 3), oriented toward the camera (the cv::rgbd way);
    the image wraps around at its borders, as `jnp.roll` does."""
    dx = torch.roll(points, -1, dims=-2) - torch.roll(points, 1, dims=-2)
    dy = torch.roll(points, -1, dims=-3) - torch.roll(points, 1, dims=-3)
    n = torch.linalg.cross(dx, dy, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-12)
    n = n * torch.where(n[..., 2:3] > 0, -1.0, 1.0)
    ok = (valid
          & torch.roll(valid, -1, dims=-1) & torch.roll(valid, 1, dims=-1)
          & torch.roll(valid, -1, dims=-2) & torch.roll(valid, 1, dims=-2)
          & (norm[..., 0] > 1e-9))
    return n, ok


def _hat(p: torch.Tensor) -> torch.Tensor:
    """Skew matrices (..., 3) -> (..., 3, 3)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], dim=-1),
                        torch.stack([z, zero, -x], dim=-1),
                        torch.stack([-y, x, zero], dim=-1)], dim=-2)


def _level_icp(ref_pts, ref_valid, ref_normals, cur_pts, cur_normals, cur_ok, cam_cur, rel0: SE3,
               cfg: IcpConfig):
    """One level over the full transforms T (B,), solved with the left
    update T <- exp(-dx) . T (the Jacobian is the left perturbation of T)."""
    B, H, W = ref_valid.shape
    P = H * W
    p_ref = ref_pts.reshape(B, P, 3)
    m_ref = ref_valid.reshape(B, P)
    n_ref = ref_normals.reshape(B, P, 3)
    q_map = cur_pts.reshape(B, P, 3)
    n_map = cur_normals.reshape(B, P, 3)
    ok_map = cur_ok.reshape(B, P)
    cam = cam_mod.expand(cam_cur, 2)

    def gather(a, idx):
        return torch.gather(a, 1, idx if a.dim() == 2 else idx[..., None].expand(-1, -1, a.shape[-1]))

    def compute_ne(T: SE3) -> NormalEquations:
        p = se3.transform_points(SE3(T.R[:, None], T.t[:, None]), p_ref)
        uv, zok = cam_mod.project(cam, p)
        u = torch.clamp(torch.floor(uv[..., 0] + 0.5), 0, W - 1).long()
        v = torch.clamp(torch.floor(uv[..., 1] + 0.5), 0, H - 1).long()
        inb = (uv[..., 0] > 1) & (uv[..., 0] < W - 1) & (uv[..., 1] > 1) & (uv[..., 1] < H - 1)
        idx = v * W + u
        q, n, qok = gather(q_map, idx), gather(n_map, idx), gather(ok_map, idx)
        d = p - q
        dist = torch.linalg.vector_norm(d, dim=-1)
        # the normal-compatibility gate (cv::rgbd's correspondence filter):
        # rejects grazing and foreground/background pairs the distance gate passes
        cos_n = ((n_ref @ T.R.transpose(-1, -2)) * n).sum(-1)
        valid = m_ref & zok & inb & qok & (dist < cfg.max_distance) & (cos_n >= cfg.min_cos_normal)
        w = valid.to(p.dtype)
        # A is not normalized by the constraint count: residuals are O(1)
        # (metres, unit normals) and dividing by thousands of points would
        # push det(A) under the solver's 1e-6 guard
        if cfg.variant == "point_to_point":
            # r = T p - q; the row of the left perturbation exp(dx) . T is [I | -[Tp]x]
            eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(B, P, 3, 3)
            J3 = torch.cat([eye, -_hat(p)], dim=-1)  # (B, P, 3, 6)
            J0 = J3.reshape(B, P * 3, 6)
            Jf = (J3 * w[..., None, None]).reshape(B, P * 3, 6)
            A = Jf.transpose(-1, -2) @ J0
            b = (Jf.transpose(-1, -2) @ d.reshape(B, P * 3, 1))[..., 0]
            chi2 = (w[..., None] * d * d).sum((-1, -2))
        else:
            r = (n * d).sum(-1)
            J = torch.cat([n, torch.linalg.cross(p, n, dim=-1)], dim=-1)
            Jw = J * w[..., None]
            A = Jw.transpose(-1, -2) @ J
            b = (Jw.transpose(-1, -2) @ r[..., None])[..., 0]
            chi2 = (w * r * r).sum(-1)
        return NormalEquations(A, b, chi2, w.sum(-1))

    def update(T: SE3, dx: torch.Tensor) -> SE3:
        return se3.orthonormalize(se3.compose(se3.exp(-dx), T))

    res = solve_gauss_newton(compute_ne, update, rel0, n_params=6, config=cfg.solver)
    return res.x, res


def align_icp(ref_frame: Frame, cur_frame: Frame, rel_init: SE3, cfg: IcpConfig = IcpConfig()):
    """Coarse-to-fine dense ICP. Frames carry one pair or a leading pair
    axis B, ``rel_init`` the same batch shape. Returns (rel, cov, valid)."""
    unbatched = ref_frame.depth[0].dim() == 2
    if unbatched:
        ref_frame, cur_frame, rel_init = (tree_map(lambda a: a[None], x)
                                          for x in (ref_frame, cur_frame, rel_init))
    B = rel_init.t.shape[0]
    n_levels = len(ref_frame.depth)
    start = cfg.coarsest_level if cfg.coarsest_level is not None else n_levels - 1
    rel = rel_init
    dtype, device = cur_frame.depth[0].dtype, cur_frame.depth[0].device
    cov = torch.eye(6, dtype=dtype, device=device).expand(B, 6, 6)
    any_valid = torch.zeros(B, dtype=torch.bool, device=device)
    for level in range(start, -1, -1):
        ref_pts, ref_valid = frame_pcl(ref_frame, level)
        cur_pts, cur_valid = frame_pcl(cur_frame, level)
        normals, n_ok = _normals_from_depth(cur_pts, cur_valid)
        ref_normals, ref_n_ok = _normals_from_depth(ref_pts, ref_valid)
        rel, res = _level_icp(ref_pts, ref_valid & ref_n_ok, ref_normals, cur_pts, normals, n_ok,
                              cur_frame.cameras[level], rel, cfg)
        cov = torch.where(res.valid[:, None, None], inv_psd(res.A), cov)
        any_valid = any_valid | res.valid
    if unbatched:
        return SE3(rel.R[0], rel.t[0]), cov[0], any_valid[0]
    return rel, cov, any_valid


class IcpAligner:
    """Host-facing wrapper with the aligner interface (`align(refs,
    ref_poses, cur, pred)` -> pose and covariance), so `OdometryIcp`
    (Odometry.cpp:65-87) takes it. Frames move to ``device`` (CUDA unless
    named) for the solve."""

    def __init__(self, cfg: IcpConfig = IcpConfig(), device=None):
        self.cfg = cfg
        self.device = resolve(device)

    def align(self, ref_frames, ref_poses, cur_frame: Frame, pred_pose: np.ndarray):
        """Align ``cur_frame`` against the first reference, starting from the
        predicted pose. Returns (pose world->cam 4x4 f64, cov 6x6, ok)."""
        ref_frame, ref_pose = ref_frames[0], ref_poses[0]
        ref_frame, cur_frame = (tree_map(lambda a: a.to(self.device), f) for f in (ref_frame, cur_frame))
        rel0 = lie_np.relative(ref_pose, pred_pose)
        dtype = cur_frame.depth[0].dtype
        rel0 = SE3(torch.as_tensor(rel0[:3, :3], dtype=dtype, device=self.device),
                   torch.as_tensor(rel0[:3, 3], dtype=dtype, device=self.device))
        return _host_pose(*align_icp(ref_frame, cur_frame, rel0, self.cfg), ref_pose)
