"""Windowed bundle adjustment: Schur-complement Levenberg-Marquardt.

Port of `vslam_tpu.ba.bundle_adjustment` (the reference's Ceres backend,
`odometry/src/mapping/BundleAdjustment.cpp`: SE3-manifold pose blocks, a
reprojection cost, DENSE_SCHUR):

- observations are padded arrays (frame index, point index, uv, depth,
  mask); residuals and closed-form Jacobians of all of them come in one
  pass;
- the block-sparse Hessian is assembled with index_add (the JAX
  segment_sums), the 3x3 point blocks invert in closed form, and the
  reduced camera system (6K x 6K, K <= 7 keyframes) is one dense solve;
- pose updates are right-multiplicative SE(3) increments (Sophus' manifold
  Plus), points behind the camera contribute nothing (BundleAdjustment.cpp:
  24-45), and pose block 0 is frozen (the gauge);
- an RGB-D depth residual per observation (obs_z > 0) anchors the scale.

`solve_ba` is a host loop that reads one scalar per iteration (the JAX
package's `lax.while_loop`), with the same accept/reject and lambda rules.
Everything runs on the device of the problem's tensors.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import lie_np, se3
from ..core.device import resolve
from ..core.se3 import SE3
from ..solvers.linalg6 import inv3
from ..utils import pow2_bucket
from ..utils.log import get_logger

__all__ = ["BaProblem", "solve_ba", "BundleAdjustment", "drift_significant", "ba_sane", "write_back", "pose_covariance",
           "effective_residual_count"]


class BaProblem(NamedTuple):
    poses: SE3  # (K,) world->cam
    pose_mask: torch.Tensor  # (K,) bool
    points: torch.Tensor  # (M, 3) world
    point_mask: torch.Tensor  # (M,) bool
    obs_frame: torch.Tensor  # (O,) int64 pose index
    obs_point: torch.Tensor  # (O,) int64 point index
    obs_uv: torch.Tensor  # (O, 2)
    obs_mask: torch.Tensor  # (O,) bool
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    # measured keypoint depth per observation (no reference equivalent: its
    # BA is reprojection-only); obs_z <= 0 disables the term
    obs_z: Optional[torch.Tensor] = None  # (O,) metres


def _residuals(p: BaProblem, poses: SE3, points: torch.Tensor, huber_c: float = 5.0):
    """r (O, 3), J_pose (O, 3, 6), J_point (O, 3, 3), valid (O,), weights (O,).

    Rows 0-1: pixel reprojection. Row 2: the depth residual (z - z_meas)
    scaled to pixels by fx / z, where obs_z > 0. With huber_c > 0 each
    observation's whole residual is Huber-weighted (IRLS: rows and
    Jacobians scaled by sqrt(w))."""
    R = poses.R[p.obs_frame]
    t = poses.t[p.obs_frame]
    X = points[p.obs_point]
    pc = torch.einsum("oij,oj->oi", R, X) + t
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    ok = (z > 0.1) & p.obs_mask  # the reference's z > 0.1 gate (BundleAdjustment.cpp:26)
    one = torch.ones_like(z)
    zero = torch.zeros_like(z)
    zs = torch.where(ok, z, one)
    u = p.fx * x / zs + p.cx
    v = p.fy * y / zs + p.cy
    r_uv = torch.stack([u, v], dim=-1) - p.obs_uv
    r_uv = torch.where(ok[:, None], r_uv, torch.zeros_like(r_uv))

    obs_z = p.obs_z if p.obs_z is not None else zero
    z_on = ok & (obs_z > 0.0)
    wz = torch.where(z_on, p.fx / zs, zero)
    r_z = torch.where(z_on, (z - obs_z) * wz, zero)

    zi = 1.0 / zs
    zi2 = zi * zi
    # d [u; v; wz z] / d pc (wz held constant within an iteration)
    Jproj = torch.stack([
        torch.stack([p.fx * zi, zero, -p.fx * x * zi2], dim=-1),
        torch.stack([zero, p.fy * zi, -p.fy * y * zi2], dim=-1),
        torch.stack([zero, zero, wz], dim=-1),
    ], dim=-2)
    # right-multiplicative perturbation pc = pose . exp(d) . X: d pc / d d = R [I | -hat(X)]
    hatX = se3.so3_hat(X)
    Dp = torch.cat([torch.eye(3, dtype=R.dtype, device=R.device).expand_as(hatX), -hatX], dim=-1)
    J_pose = torch.einsum("oab,obc,ocd->oad", Jproj, R, Dp)
    J_point = torch.einsum("oab,obc->oac", Jproj, R)
    J_pose = torch.where(ok[:, None, None], J_pose, torch.zeros_like(J_pose))
    J_point = torch.where(ok[:, None, None], J_point, torch.zeros_like(J_point))

    r = torch.cat([r_uv, r_z[:, None]], dim=-1)
    w = torch.ones_like(z)
    if huber_c and huber_c > 0:
        rn = torch.linalg.vector_norm(r, dim=-1)
        w = torch.where(rn > huber_c, huber_c / torch.clamp(rn, min=1e-9), one)
        sw = torch.sqrt(w)[:, None]
        r = r * sw
        J_pose = J_pose * sw[..., None]
        J_point = J_point * sw[..., None]
    return r, J_pose, J_point, ok, w


def _chi2(p: BaProblem, poses: SE3, points: torch.Tensor, huber_c: float = 5.0) -> torch.Tensor:
    r = _residuals(p, poses, points, huber_c)[0]
    return torch.sum(r * r)


def effective_residual_count(p: BaProblem, poses: SE3, points: torch.Tensor, huber_c: float = 5.0):
    """Huber-effective number of scalar residuals at the solution: over the
    valid observations, w x (2 pixel rows + 1 depth row where present). The
    residual variance chi2 / (n_eff - dof) must divide by this, since chi2
    is Huber-downweighted."""
    _, _, _, ok, w = _residuals(p, poses, points, huber_c)
    obs_z = p.obs_z if p.obs_z is not None else torch.zeros_like(w)
    rows = 2.0 + (ok & (obs_z > 0.0)).to(w.dtype)
    return torch.sum(torch.where(ok, w * rows, torch.zeros_like(w)))


def _schur_dense(p: BaProblem, poses: SE3, points: torch.Tensor, lam, huber_c: float):
    """The gauge-fixed dense reduced camera system: (Sd (6K, 6K), rhs_d
    (6K,), free6, Vinv, Wkm, bx), shared by the LM step and the pose
    covariance."""
    K = poses.t.shape[0]
    M = points.shape[0]
    r, Jp, Jx, ok, _ = _residuals(p, poses, points, huber_c)
    dtype, dev = r.dtype, r.device

    def seg(vals, idx, n):
        return torch.zeros((n,) + vals.shape[1:], dtype=dtype, device=dev).index_add_(0, idx, vals)

    U = seg(torch.einsum("oai,oaj->oij", Jp, Jp), p.obs_frame, K)
    V = seg(torch.einsum("oai,oaj->oij", Jx, Jx), p.obs_point, M)
    Wkm = seg(torch.einsum("oai,oaj->oij", Jp, Jx), p.obs_frame * M + p.obs_point, K * M).reshape(K, M, 6, 3)
    bp = -seg(torch.einsum("oai,oa->oi", Jp, r), p.obs_frame, K)
    bx = -seg(torch.einsum("oai,oa->oi", Jx, r), p.obs_point, M)

    # Levenberg identity damping; also keeps empty padded blocks invertible
    U = U + lam * torch.eye(6, dtype=dtype, device=dev)
    V = V + lam * torch.eye(3, dtype=dtype, device=dev)

    Vinv = inv3(V)
    WVi = torch.einsum("kmij,mjl->kmil", Wkm, Vinv)
    S = -torch.einsum("kmil,nmjl->knij", WVi, Wkm)  # (K, K, 6, 6)
    kk = torch.arange(K, device=dev)
    S[kk, kk] = S[kk, kk] + U
    rhs = bp - torch.einsum("kmil,ml->ki", WVi, bx)

    # gauge: freeze pose block 0 and any invalid slot
    free = p.pose_mask & (kk > 0)
    Sd = S.permute(0, 2, 1, 3).reshape(K * 6, K * 6)
    free6 = torch.repeat_interleave(free, 6)
    Sd = torch.where(free6[:, None] & free6[None, :], Sd, torch.zeros_like(Sd))
    Sd = Sd + torch.diag(torch.where(free6, 0.0, 1.0).to(dtype))
    rhs_d = torch.where(free6, rhs.reshape(-1), torch.zeros_like(rhs.reshape(-1)))
    return Sd, rhs_d, free6, Vinv, Wkm, bx


def pose_covariance(p: BaProblem, poses: SE3, points: torch.Tensor, slot: int, huber_c: float = 5.0):
    """6x6 covariance of pose block ``slot`` at the solution, in the solver's
    right-multiplicative tangent (pose_new = pose . exp(d)): that block of
    the reduced camera system's inverse. Unscaled: multiply by the residual
    variance (pixels, so the scale is physical)."""
    Sd = _schur_dense(p, poses, points, torch.tensor(1e-8, dtype=points.dtype, device=points.device),
                      huber_c)[0]
    e = torch.zeros((Sd.shape[0], 6), dtype=Sd.dtype, device=Sd.device)
    e[slot * 6 : (slot + 1) * 6, :] = torch.eye(6, dtype=Sd.dtype, device=Sd.device)
    X = torch.linalg.solve(Sd, e)
    return X[slot * 6 : (slot + 1) * 6, :]


def _lm_step(p: BaProblem, poses: SE3, points: torch.Tensor, lam, huber_c: float):
    K = poses.t.shape[0]
    Sd, rhs_d, _, Vinv, Wkm, bx = _schur_dense(p, poses, points, lam, huber_c)
    dp = torch.linalg.solve(Sd, rhs_d).reshape(K, 6)
    dx = torch.einsum("mij,mj->mi", Vinv, bx - torch.einsum("kmil,ki->ml", Wkm, dp))
    dx = torch.where(p.point_mask[:, None], dx, torch.zeros_like(dx))
    poses_new = se3.orthonormalize(se3.compose(poses, se3.exp(dp)))
    return poses_new, points + dx


def solve_ba(p: BaProblem, max_iterations: int = 50, lambda0: float = 1e-4, min_step: float = 1e-10,
             huber_c: float = 5.0) -> Tuple[SE3, torch.Tensor, torch.Tensor, torch.Tensor]:
    """LM with accept/reject. Returns (poses, points, chi2_before,
    chi2_after), the reference's errorBefore / errorAfter
    (BundleAdjustment.h:34-45)."""
    chi2_0 = _chi2(p, p.poses, p.points, huber_c)
    poses, points, chi2 = p.poses, p.points, chi2_0
    lam = torch.tensor(lambda0, dtype=p.points.dtype, device=p.points.device)
    it = 0
    done = False
    while not done and it < max_iterations:
        poses_new, points_new = _lm_step(p, poses, points, lam, huber_c)
        chi2_new = _chi2(p, poses_new, points_new, huber_c)
        accept = (chi2_new < chi2) & torch.isfinite(chi2_new)
        poses = SE3(torch.where(accept, poses_new.R, poses.R), torch.where(accept, poses_new.t, poses.t))
        points = torch.where(accept, points_new, points)
        small = accept & (torch.abs(chi2 - chi2_new) < min_step * torch.clamp(chi2, min=1.0))
        chi2 = torch.where(accept, chi2_new, chi2)
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-9), torch.clamp(lam * 5.0, max=1e8))
        it += 1
        done = bool(small | (lam >= 1e8))  # the iteration's one read
    return poses, points, chi2_0, chi2


# the chi2 inverse CDF at 0.99 for 6 dof
_CHI2_6_99 = 16.81


def drift_significant(ba: "BundleAdjustment", est_pose: np.ndarray, corrected: np.ndarray,
                      min_correction: float = 1e-3) -> bool:
    """True when BA's correction of the newest keyframe exceeds BA's own pose
    uncertainty (`ba.last_newest_cov`, the variance-scaled Schur inverse
    block): measured drift, not solver jitter. Without a covariance, the
    absolute ``min_correction`` floor decides."""
    d_r = lie_np.log(lie_np.inv(est_pose) @ corrected)  # corrected = est . exp(d_r)
    cov = getattr(ba, "last_newest_cov", None)
    if cov is None or not np.all(np.isfinite(cov)):
        return bool(np.linalg.norm(d_r) >= min_correction)
    try:
        m2 = float(d_r @ np.linalg.solve(cov, d_r))
    except np.linalg.LinAlgError:
        return bool(np.linalg.norm(d_r) >= min_correction)
    return m2 > _CHI2_6_99 and np.linalg.norm(d_r) >= min_correction


def ba_sane(keyframes, poses: Dict[int, np.ndarray], max_translation: float = 0.3,
            max_rotation: float = 0.3) -> bool:
    """Reject a BA solution that moves a keyframe implausibly far from its
    odometry pose (a wrong landmark association can lower the reprojection
    chi2 while wrecking the trajectory). A rejection is the policy at work,
    not a failure: it is logged at info on the "mapping" logger."""
    for f in keyframes:
        if f.id in poses:
            xi = lie_np.log(lie_np.relative(f.pose, poses[f.id]))
            if np.linalg.norm(xi[:3]) > max_translation or np.linalg.norm(xi[3:]) > max_rotation:
                get_logger("mapping").info("BA rejected: frame %d moved %.3f m", f.id, np.linalg.norm(xi[:3]))
                return False
    return True


def write_back(ba: "BundleAdjustment", slam_map, graph, frame_id: int, est_pose: np.ndarray, mode: str,
               min_correction: float = 1e-3) -> Optional[np.ndarray]:
    """The windowed BA over ``slam_map`` and its write-back policy
    (NodeMapping.cpp:162-180). A solution that lowers the chi2 and passes
    `ba_sane` moves the landmarks; then "always" moves every keyframe (the
    reference's Map::updatePoses), "gated" only the newest one (``frame_id``,
    estimated at ``est_pose``) where `drift_significant`, "off" none. The
    pose graph ``graph`` (or None) follows the moved keyframes. Returns the
    newest keyframe's corrected pose where it moved, else None."""
    poses, points, err0, err1 = ba.optimize(slam_map)
    if not (err1 < err0 and ba_sane(slam_map.keyframes(), poses)):
        return None
    slam_map.update_points(points)
    corrected = poses[frame_id]
    if mode == "always":
        moved = poses
    elif mode == "gated" and drift_significant(ba, est_pose, corrected, min_correction):
        # real drift: the newest keyframe only; the older ones (the
        # landmarks' anchors) keep their odometry poses
        moved = {frame_id: corrected}
    else:
        return None
    slam_map.update_poses(moved)
    if graph is not None:
        for fid, T in moved.items():
            graph.update_pose(fid, T)
    return corrected


class BundleAdjustment:
    """Host wrapper: the map's keyframes and landmarks padded to power-of-two
    sizes, the Schur-LM solve on ``device`` (CUDA unless named), the updated
    poses and points keyed by id (the reference's Results,
    BundleAdjustment.h:34-45)."""

    def __init__(self, max_iterations: int = 50, compute_pose_covariance: bool = True, device=None):
        self.max_iterations = int(max_iterations)
        # the newest keyframe's 6x6 covariance (right-multiplicative tangent,
        # variance-scaled) from the last optimize(); only the "gated"
        # write-back reads it, so the other modes skip its second assembly
        self.compute_pose_covariance = bool(compute_pose_covariance)
        self.device = resolve(device)
        self.last_newest_cov: Optional[np.ndarray] = None

    @staticmethod
    def _bucket(n: int, minimum: int = 8) -> int:
        return pow2_bucket(n, minimum)

    def optimize(self, slam_map) -> Tuple[Dict[int, np.ndarray], Dict[int, np.ndarray], float, float]:
        from ..features.tracking import _cam_floats

        kfs = slam_map.keyframes()
        if len(kfs) < 2:
            raise ValueError("BA needs at least 2 keyframes")
        kf_ids = [f.id for f in kfs]
        kf_index = {fid: i for i, fid in enumerate(kf_ids)}

        obs = []  # (k, m, u, v, z)
        pts = []
        pt_index: Dict[int, int] = {}
        for lm in slam_map.points():
            rows = [(kf_index[fid], fi) for fid, fi in lm.observations.items() if fid in kf_index]
            if len(rows) < 2:
                continue
            if lm.id not in pt_index:
                pt_index[lm.id] = len(pts)
                pts.append(lm.position)
            m = pt_index[lm.id]
            for k, fi in rows:
                uv = kfs[k].keypoints[fi]
                z = 0.0
                if kfs[k].kp_depth is not None and fi < len(kfs[k].kp_depth):
                    z = float(kfs[k].kp_depth[fi])
                obs.append((k, m, float(uv[0]), float(uv[1]), z))
        if len(obs) < 6:
            raise ValueError(f"BA needs more observations, have {len(obs)}")

        K = len(kfs)
        M = self._bucket(len(pts))
        O = self._bucket(len(obs), minimum=32)
        points = np.zeros((M, 3), np.float32)
        points[: len(pts)] = np.stack(pts)
        point_mask = np.zeros(M, bool)
        point_mask[: len(pts)] = True
        obs_arr = np.zeros((O, 5), np.float32)
        obs_mask = np.zeros(O, bool)
        obs_arr[: len(obs)] = np.asarray(obs, np.float32)
        obs_mask[: len(obs)] = True

        # gauge: the oldest keyframe (last in the window's order) is slot 0
        order = np.arange(K)[::-1]
        inv_order = np.argsort(order)
        dev = self.device
        t = lambda a, dtype=None: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
        R0 = np.stack([f.pose[:3, :3] for f in kfs]).astype(np.float32)
        t0 = np.stack([f.pose[:3, 3] for f in kfs]).astype(np.float32)
        fx, fy, cx, cy = (t(np.float32(c)) for c in _cam_floats(kfs[0].frame.cameras[0]))
        problem = BaProblem(
            poses=SE3(t(R0[order]), t(t0[order])),
            pose_mask=torch.ones(K, dtype=torch.bool, device=dev),
            points=t(points),
            point_mask=t(point_mask),
            obs_frame=t(inv_order[obs_arr[:, 0].astype(np.int64)], torch.int64),
            obs_point=t(obs_arr[:, 1].astype(np.int64)),
            obs_uv=t(obs_arr[:, 2:4]),
            obs_mask=t(obs_mask),
            obs_z=t(obs_arr[:, 4]),
            fx=fx, fy=fy, cx=cx, cy=cy,
        )
        poses_out, points_out, err0, err1 = solve_ba(problem, max_iterations=self.max_iterations)
        parts = [poses_out.R.reshape(-1), poses_out.t.reshape(-1), points_out.reshape(-1), err0.reshape(1),
                 err1.reshape(1)]
        if self.compute_pose_covariance:
            slot_newest = int(inv_order[0])
            parts += [pose_covariance(problem, poses_out, points_out, slot_newest).reshape(-1),
                      effective_residual_count(problem, poses_out, points_out).reshape(1)]
        flat = torch.cat(parts).cpu().numpy().astype(np.float64)  # the one fetch
        R_all = flat[: 9 * K].reshape(K, 3, 3)
        t_all = flat[9 * K : 12 * K].reshape(K, 3)
        o = 12 * K + 3 * M
        pts_all = flat[12 * K : o].reshape(M, 3)
        err0, err1 = float(flat[o]), float(flat[o + 1])

        pose_updates: Dict[int, np.ndarray] = {}
        for i, fid in enumerate(kf_ids):
            slot = int(inv_order[i])
            T = np.eye(4)
            u, _, vt = np.linalg.svd(R_all[slot])
            T[:3, :3] = u @ vt
            T[:3, 3] = t_all[slot]
            pose_updates[fid] = T
        point_updates = {pid: pts_all[m] for pid, m in pt_index.items()}

        if self.compute_pose_covariance:
            cov_h, n_eff = flat[o + 2 : o + 38].reshape(6, 6), flat[o + 38]
            dof = max(float(n_eff) - (6 * (K - 1) + 3 * len(pts)), 1.0)
            self.last_newest_cov = cov_h * (err1 / dof)
        else:
            self.last_newest_cov = None
        return pose_updates, point_updates, err0, err1
