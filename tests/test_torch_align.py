"""End-to-end parity of the port's alignment entry points with the JAX package.

* `align_pairs`: B=2 pairs, 3 pyramid levels, against JAX `align_pairs`
  (vmap), for the `gather` sampler and for `fused_gn` (the JAX Pallas kernel
  in interpret mode; the port's plain version of its CUDA kernel on CPU).
  Pose within 1e-3, covariance within rtol 1e-2, and each pair inside the
  reference's per-pair budget of 0.01 (`test_alignment_se3.cpp:119`).
* `RgbdAligner`: two stacked reference frames with the motion prior at
  nearest sampling, the problem of `test_alignment.py::
  test_fused_gn_stacked_with_prior_matches_gather`, with that test's
  ground-truth budget (0.02).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vslam_tpu.alignment import AlignmentConfig as JAlignmentConfig
from vslam_tpu.alignment import RgbdAligner as JRgbdAligner
from vslam_tpu.core import lie_np
from vslam_tpu.core.camera import Camera as JCamera
from vslam_tpu.core.frame import create_frame as j_create_frame
from vslam_tpu.core.se3 import SE3 as JSE3
from vslam_tpu.io import synthetic
from vslam_tpu.parallel.batched import align_pairs as j_align_pairs
from vslam_tpu.solvers import SolverConfig as JSolverConfig
from vslam_tpu_torch import interop
from vslam_tpu_torch.alignment import RgbdAligner as TRgbdAligner
from vslam_tpu_torch.parallel.batched import align_pairs as t_align_pairs
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pose(R, t):
    T = np.eye(4)
    T[:3, :3] = np.asarray(R, np.float64)
    T[:3, 3] = np.asarray(t, np.float64)
    return T


@pytest.fixture(scope="module")
def pairs():
    H, W = 96, 128
    fx = 525.0 * W / 640
    K = synthetic.camera_matrix(fx, fx, (W - 1) / 2, (H - 1) / 2)
    cam = JCamera.create(fx, fx, (W - 1) / 2, (H - 1) / 2)
    rng = np.random.default_rng(0)
    refs, curs, xis = [], [], []
    for b in range(2):
        xi = np.concatenate([rng.uniform(-0.02, 0.02, 3), rng.uniform(-0.01, 0.01, 3)])
        scene = synthetic.default_scene(seed=b)
        for lst, pose in ((refs, np.eye(4)), (curs, lie_np.exp(xi))):
            inten, depth = synthetic.render(K, pose, (H, W), scene)
            lst.append(j_create_frame(jnp.asarray(inten), jnp.asarray(depth), cam, n_levels=3))
        xis.append(xi)
    stack = lambda fs: jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *fs)  # noqa: E731
    return stack(refs), stack(curs), xis, fx


@pytest.mark.parametrize("sampler", ["gather", "fused_gn"])
def test_align_pairs_matches_jax(pairs, sampler):
    ref, cur, xis, fx = pairs
    cfg = JAlignmentConfig(
        min_gradient=10.0,
        solver=JSolverConfig(max_iterations=30, min_step_size=1e-11, min_relative_reduction=1e-4),
        include_prior=True,
        prior_weight=(fx / 525.0) ** 2,
        interpolation="bilinear",
        sampler=sampler,
        max_points=2048,
    )
    B = len(xis)
    rel0 = JSE3(jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (B, 3, 3)), jnp.zeros((B, 3), jnp.float32))
    rel_j, cov_j, valid_j = _np_tree(j_align_pairs(ref, cur, rel0, None, cfg))
    rel_t, cov_t, valid_t = t_align_pairs(
        interop.frame_from_numpy(_np_tree(ref), device="cpu"),
        interop.frame_from_numpy(_np_tree(cur), device="cpu"),
        interop.se3_from_numpy(_np_tree(rel0), device="cpu"),
        None,
        interop.alignment_config_from_fields(dataclasses.asdict(cfg)),
    )
    np.testing.assert_array_equal(valid_t.numpy(), valid_j)
    assert valid_j.all()
    for b in range(B):
        T_j = _pose(rel_j.R[b], rel_j.t[b])
        T_t = _pose(rel_t.R[b], rel_t.t[b])
        assert np.linalg.norm(lie_np.log(lie_np.inv(T_j) @ T_t)) < 1e-3
        u, _, vt = np.linalg.svd(T_t[:3, :3])
        T_t[:3, :3] = u @ vt
        assert np.linalg.norm(lie_np.log(T_t) - xis[b]) < 0.01  # per-pair ground truth
    np.testing.assert_allclose(cov_t.numpy(), cov_j, rtol=1e-2, atol=1e-6 * np.abs(cov_j).max())


@pytest.mark.parametrize("sampler", ["gather", "fused_gn"])
def test_rgbd_aligner_stacked_with_prior_matches_jax(sampler):
    H, W, FX = 120, 160, 130.0
    K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    cam = JCamera.create(FX, FX, (W - 1) / 2, (H - 1) / 2)
    xi01 = np.array([0.008, -0.004, 0.006, 0.002, -0.003, 0.001])
    xi12 = np.array([0.006, 0.005, -0.004, -0.002, 0.002, 0.002])
    p0 = np.eye(4)
    p1 = lie_np.exp(xi01) @ p0
    p2 = lie_np.exp(xi12) @ p1
    frames = []
    for pose in (p0, p1, p2):
        inten, depth = synthetic.render(K, pose, (H, W))
        frames.append(j_create_frame(jnp.asarray(inten), jnp.asarray(depth), cam, n_levels=3))
    cfg = JAlignmentConfig(
        min_gradient=10.0, solver=JSolverConfig(max_iterations=60, min_step_size=1e-7),
        include_prior=True, interpolation="nearest", max_points=2048, sampler=sampler,
    )
    pred = lie_np.exp(xi12) @ p1
    pose_j, cov_j, ok_j = JRgbdAligner(cfg).align(frames[:2], [p0, p1], frames[2], pred)
    t_frames = [interop.frame_from_numpy(_np_tree(f), device="cpu") for f in frames]
    t_cfg = interop.alignment_config_from_fields(dataclasses.asdict(cfg))
    pose_t, cov_t, ok_t = TRgbdAligner(t_cfg).align(t_frames[:2], [p0, p1], t_frames[2], pred)
    assert ok_j and ok_t
    assert np.linalg.norm(lie_np.log(lie_np.relative(pose_t, p2))) < 0.02  # ground truth
    assert np.linalg.norm(lie_np.log(lie_np.relative(pose_j, pose_t))) < 1e-3
    assert cov_t.shape == (6, 6) and cov_t.dtype == np.float64
    np.testing.assert_allclose(cov_t, cov_j, rtol=1e-2, atol=1e-6 * np.abs(cov_j).max())
