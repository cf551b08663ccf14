"""The port's windowed bundle adjustment (`vslam_tpu_torch.ba.
bundle_adjustment`) against the JAX package's, on `tests/test_ba.py`'s
problems (a 3-pose arc, 40 points, perturbed poses and points, from a
seeded numpy generator).

Both solve in f32 and accept or reject each LM step on one chi2
comparison, so final states are compared, not iterations. Tolerances:
* depth-anchored problem (the scale fixed): poses within 1e-4 (SE(3) log
  norm), points within 1e-3 m, chi2 before within rtol 1e-5, both final
  chi2 below 1e-2 of the initial;
* reprojection-only problem (the scale along a flat direction): rotations
  within 1e-4 rad and translation directions within 1e-4 (cosine), both
  final chi2 below 1e-3 of the initial;
* on the depth-anchored problem with half-pixel observation noise (so the
  residuals at the solution are measurements, not rounding): `_residuals`,
  `effective_residual_count` and `pose_covariance` at the JAX solution
  within rtol 1e-4 (of the largest entry); `BundleAdjustment.optimize`
  through a Map: the same keys, poses within 1e-4, points within 1e-3 m,
  errors within rtol 1e-4, the newest keyframe's variance-scaled covariance
  within rtol 1e-2 of its largest entry;
* `inv3` within rtol 1e-5, `drift_significant` equal decisions.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.ba import bundle_adjustment as jba
from vslam_tpu.core.camera import Camera as JCamera
from vslam_tpu.core.frame import create_frame as jcreate_frame
from vslam_tpu.odometry import map as jmap
from vslam_tpu.solvers import linalg6 as jlinalg6
from vslam_tpu_torch import interop
from vslam_tpu_torch.ba import bundle_adjustment as tba
from vslam_tpu_torch.core import lie_np
from vslam_tpu_torch.core.camera import Camera
from vslam_tpu_torch.core.frame import create_frame
from vslam_tpu_torch.odometry import map as tmap
from vslam_tpu_torch.solvers import linalg6

from test_ba import CX, CY, FX, FY, make_problem
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)


def _depth_anchored(problem, poses_gt, points_gt):
    obs_z = []
    for k, m in zip(np.asarray(problem.obs_frame), np.asarray(problem.obs_point)):
        obs_z.append(lie_np.transform(poses_gt[int(k)], points_gt[int(m)][None, :])[0][2])
    return problem._replace(obs_z=jnp.asarray(obs_z, jnp.float32))


def _T(R, t):
    T = np.eye(4)
    T[:3, :3] = np.asarray(R, np.float64)
    T[:3, 3] = np.asarray(t, np.float64)
    return T


@pytest.fixture(scope="module")
def problems():
    problem, poses_gt, points_gt = make_problem(np.random.default_rng(42))
    depth = _depth_anchored(problem, poses_gt, points_gt)
    # half-pixel observation noise: residuals at the solution are then
    # measurements, not rounding (the covariance is scaled by their variance)
    uv = np.asarray(depth.obs_uv) + np.random.default_rng(7).normal(0.0, 0.5, np.asarray(depth.obs_uv).shape)
    return {"reprojection": problem, "depth": depth, "noisy": depth._replace(obs_uv=jnp.asarray(uv, jnp.float32))}


@pytest.fixture(scope="module")
def jax_solutions(problems):
    return {k: jba._solve_ba_jit(p, max_iterations=40) for k, p in problems.items()}


@pytest.mark.parametrize("kind", ["depth", "reprojection"])
def test_solve_ba_matches_jax(problems, jax_solutions, kind):
    jp, jpts, jc0, jc1 = jax_solutions[kind]
    tp, tpts, tc0, tc1 = tba.solve_ba(interop.ba_problem_from_numpy(problems[kind], device="cpu"),
                                      max_iterations=40)
    np.testing.assert_allclose(float(tc0), float(jc0), rtol=1e-5)
    limit = 1e-2 if kind == "depth" else 1e-3
    assert float(tc1) < limit * float(tc0) and float(jc1) < limit * float(jc0)
    for k in range(3):
        Tj = _T(jp.R[k], jp.t[k])
        Tt = _T(tp.R[k], tp.t[k])
        if kind == "depth":
            assert np.linalg.norm(lie_np.log(lie_np.relative(Tt, Tj))) < 1e-4
        else:
            assert np.linalg.norm(lie_np.matrix_to_rotvec(Tt[:3, :3].T @ Tj[:3, :3])) < 1e-4
            if k > 0:
                cos = Tt[:3, 3] @ Tj[:3, 3] / (np.linalg.norm(Tt[:3, 3]) * np.linalg.norm(Tj[:3, 3]))
                assert cos > 1 - 1e-4
    if kind == "depth":
        np.testing.assert_allclose(tpts.numpy(), np.asarray(jpts), atol=1e-3)


def test_solve_ba_edge_cases_match_jax(problems):
    """Points behind the camera are ignored, a noise-free problem stays put."""
    problem = problems["reprojection"]
    pts = np.asarray(problem.points).copy()
    pts[:3, 2] = -1.0
    behind = problem._replace(points=jnp.asarray(pts))
    _, _, jc0, jc1 = jba._solve_ba_jit(behind, max_iterations=20)
    _, _, tc0, tc1 = tba.solve_ba(interop.ba_problem_from_numpy(behind, device="cpu"), max_iterations=20)
    np.testing.assert_allclose(float(tc0), float(jc0), rtol=1e-5)
    assert np.isfinite(float(tc1)) and float(tc1) <= float(tc0)
    clean, _, _ = make_problem(np.random.default_rng(1), noise_pose=0.0, noise_point=0.0)
    _, _, tc0, tc1 = tba.solve_ba(interop.ba_problem_from_numpy(clean, device="cpu"), max_iterations=10)
    assert float(tc0) < 1e-4 and float(tc1) <= float(tc0) + 1e-6


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, atol=rtol * np.abs(want).max(), rtol=0)


def test_residuals_covariance_and_count_match_jax(problems, jax_solutions):
    p = problems["noisy"]
    jp, jpts, _, _ = jax_solutions["noisy"]
    tp = interop.ba_problem_from_numpy(p, device="cpu")
    poses = interop.se3_from_numpy(jp, device="cpu")
    pts = torch.tensor(np.asarray(jpts))
    for got, want in zip(tba._residuals(tp, poses, pts), jba._residuals(p, jp, jpts)):
        _close(got.numpy(), np.asarray(want), 1e-4)
    _close(tba.effective_residual_count(tp, poses, pts).numpy(), np.asarray(jba.effective_residual_count(p, jp, jpts)),
           1e-4)
    for slot in (1, 2):
        _close(tba.pose_covariance(tp, poses, pts, slot).numpy(), np.asarray(jba.pose_covariance(p, jp, jpts, slot)),
               1e-4)


def test_inv3_matches_jax():
    A = np.random.default_rng(0).normal(size=(5, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(linalg6.inv3(torch.from_numpy(A)).numpy(), np.asarray(jlinalg6.inv3(jnp.asarray(A))),
                               rtol=1e-5, atol=1e-7)


def test_drift_significant_matches_jax():
    rng = np.random.default_rng(2)
    L = rng.normal(size=(6, 6)) * 1e-3
    covs = [None, L @ L.T + 1e-8 * np.eye(6), np.full((6, 6), np.nan)]
    est = lie_np.exp(rng.normal(size=6) * 0.1)
    for cov in covs:
        ba = types.SimpleNamespace(last_newest_cov=cov)
        for scale in (1e-5, 1e-3, 1e-2, 1e-1):
            corrected = est @ lie_np.exp(rng.normal(size=6) * scale)
            assert tba.drift_significant(ba, est, corrected) == jba.drift_significant(ba, est, corrected)


def _ba_map(problem, port: bool):
    """The problem as a Map of three keyframes and their landmarks."""
    if port:
        cam = Camera.create(FX, FY, CX, CY, device="cpu")
        dummy = create_frame(torch.zeros(24, 32), torch.ones(24, 32), cam, n_levels=1)
        m, HostFrame, Landmark = tmap.Map(), tmap.HostFrame, tmap.Landmark
    else:
        dummy = jcreate_frame(jnp.zeros((24, 32), jnp.float32), jnp.ones((24, 32), jnp.float32),
                              JCamera.create(FX, FY, CX, CY), n_levels=1)
        m, HostFrame, Landmark = jmap.Map(), jmap.HostFrame, jmap.Landmark
    frames = []
    for k in range(3):
        f = HostFrame(frame=dummy, t_ns=k, pose=_T(problem.poses.R[k], problem.poses.t[k]), id=1000 + k)
        frames.append(f)
        m.insert(f, is_keyframe=True)
    obs_f, obs_p = np.asarray(problem.obs_frame), np.asarray(problem.obs_point)
    obs_uv, obs_z = np.asarray(problem.obs_uv), np.asarray(problem.obs_z)
    lms, kps, zs = {}, [[] for _ in range(3)], [[] for _ in range(3)]
    for o in range(len(obs_f)):
        k, mm = int(obs_f[o]), int(obs_p[o])
        if mm not in lms:
            lms[mm] = Landmark(position=np.asarray(problem.points)[mm].astype(np.float64), id=5000 + mm)
        lms[mm].observations[frames[k].id] = len(kps[k])
        kps[k].append(obs_uv[o])
        zs[k].append(obs_z[o])
    for k in range(3):
        frames[k].keypoints = np.asarray(kps[k], np.float32)
        frames[k].kp_depth = np.asarray(zs[k], np.float32)
    m.insert_points(list(lms.values()))
    return m


def test_bundle_adjustment_optimize_matches_jax(problems):
    problem = problems["noisy"]
    jposes, jpts, je0, je1 = (jb := jba.BundleAdjustment(max_iterations=40)).optimize(_ba_map(problem, False))
    tb = tba.BundleAdjustment(max_iterations=40, device="cpu")
    tposes, tpts, te0, te1 = tb.optimize(_ba_map(problem, True))
    assert tposes.keys() == jposes.keys() and tpts.keys() == jpts.keys()
    for fid in jposes:
        assert np.linalg.norm(lie_np.log(lie_np.relative(tposes[fid], jposes[fid]))) < 1e-4
    for pid in jpts:
        np.testing.assert_allclose(tpts[pid], jpts[pid], atol=1e-3)
    np.testing.assert_allclose([te0, te1], [je0, je1], rtol=1e-4, atol=1e-6)
    _close(tb.last_newest_cov, jb.last_newest_cov, 1e-2)
