"""The host pipeline's parts against the JAX package's.

* Motion models: NoMotion, ConstantMotion and Kalman fed the same
  numpy-seeded pose, time and covariance sequence predict within 1e-5
  (Kalman, an f32 filter on both sides: 1e-4).
* `RgbdAligner.align(ref_data=)` and `align_build` against JAX's on the same
  frames, with `tests/test_torch_align.py`'s tolerances (pose 1e-3,
  covariance rtol 1e-2); `debug_images` within 1e-3, masks equal.
* The `visible_map` keyframe policy and `OdometryIcp` with an aligner
  passed in, mirroring `tests/test_odometry.py`.

The whole pipeline is held in `tests/test_torch_pipeline.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.alignment import RgbdAligner as JRgbdAligner
from vslam_tpu.alignment import aligner as jaligner
from vslam_tpu.alignment import ic as jic
from vslam_tpu.core.camera import Camera as JCamera
from vslam_tpu.core.frame import create_frame as j_create_frame
from vslam_tpu.odometry import motion_model as jmm
from vslam_tpu.odometry.map import Map as JMap
from vslam_tpu.odometry.odometry import OdometryIcp as JOdometryIcp
from vslam_tpu_torch import interop
from vslam_tpu_torch.alignment import aligner as taligner
from vslam_tpu_torch.alignment import ic as tic
from vslam_tpu_torch.core import lie_np
from vslam_tpu_torch.core.camera import Camera
from vslam_tpu_torch.core.frame import create_frame
from vslam_tpu_torch.io import synthetic
from vslam_tpu_torch.odometry import motion_model as tmm
from vslam_tpu_torch.odometry.keyframe import KeyFrameSelectionCustom
from vslam_tpu_torch.odometry.map import HostFrame, Landmark, Map
from vslam_tpu_torch.odometry.odometry import OdometryIcp
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

H, W, FX = 96, 128, 110.0
CX, CY = (W - 1) / 2, (H - 1) / 2
K = synthetic.camera_matrix(FX, FX, CX, CY)
DT_NS = int(1e9 / 30)


def _gap(a, b) -> float:
    return float(np.linalg.norm(lie_np.log(lie_np.relative(a, b))))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _encode(inten, depth):
    return (np.clip(np.round(inten), 0, 255).astype(np.uint8),
            np.clip(np.round(depth * 5000.0), 0, 65535).astype(np.uint16))


# ---------------------------------------------------------------------------
# motion models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,tol", [("NoMotion", 1e-5), ("ConstantMotion", 1e-5), ("Kalman", 1e-4)])
def test_motion_models_predict_as_jax(model, tol):
    rng = np.random.default_rng(7)
    j = jmm.make_motion_prediction(model)
    t = tmm.make_motion_prediction(model, device="cpu")
    pose, t_ns = np.eye(4), 0
    for i in range(10):
        t_ns += int(rng.integers(20, 45) * 1e6)
        np.testing.assert_allclose(t.predict(t_ns), j.predict(t_ns), rtol=0, atol=tol)
        xi = np.concatenate([rng.uniform(-0.02, 0.02, 3), rng.uniform(-0.01, 0.01, 3)])
        pose = lie_np.exp(xi) @ pose
        A = rng.normal(size=(6, 6))
        cov = None if i % 3 == 0 else A @ A.T * 1e-4 + np.eye(6) * 1e-5
        t.update(pose, t_ns, cov=cov)
        j.update(pose, t_ns, cov=cov)
        np.testing.assert_allclose(t.speed(), j.speed(), rtol=0, atol=tol * 30)
        np.testing.assert_allclose(t.speed_host(), j.speed_host(), rtol=0, atol=tol * 30)
    if model != "NoMotion":
        with pytest.raises(ValueError, match="older"):
            t.update(pose, t_ns - 1)


# ---------------------------------------------------------------------------
# the aligner's cached-reference paths
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def three_frames():
    """Three frames along a small motion with 2048-point interest sets, at
    nearest sampling with the prior (test_torch_align.py's aligner case)."""
    xi01 = np.array([0.008, -0.004, 0.006, 0.002, -0.003, 0.001])
    xi12 = np.array([0.006, 0.005, -0.004, -0.002, 0.002, 0.002])
    poses = [np.eye(4)]
    poses.append(lie_np.exp(xi01) @ poses[0])
    poses.append(lie_np.exp(xi12) @ poses[1])
    raw = [_encode(*synthetic.render(K, p, (H, W))) for p in poses]
    cfg = jic.AlignmentConfig(min_gradient=10.0, solver=jic.SolverConfig(max_iterations=60, min_step_size=1e-7),
                              include_prior=True, interpolation="nearest", max_points=2048)
    jcam = JCamera.create(FX, FX, CX, CY)
    build = jax.jit(j_create_frame, static_argnames="n_levels")  # eager JAX costs seconds a frame
    jframes = [build(jnp.asarray(i, jnp.float32), jnp.asarray(d, jnp.float32) / 5000.0, jcam, n_levels=3)
               for i, d in raw]
    pred = lie_np.exp(xi12) @ poses[1]
    return poses, raw, cfg, jframes, pred


def test_cached_align_and_align_build_match_jax(three_frames):
    poses, raw, cfg, jframes, pred = three_frames
    t_cfg = interop.alignment_config_from_fields(dataclasses.asdict(cfg))
    jal, tal = JRgbdAligner(cfg), taligner.RgbdAligner(t_cfg)
    precompute = jax.jit(jic.precompute_frame, static_argnums=1)
    jdata = [precompute(f, cfg) for f in jframes[:2]]
    tframes = [interop.frame_from_numpy(_np_tree(f), device="cpu") for f in jframes]
    tdata = [tic.precompute_frame(f, t_cfg) for f in tframes[:2]]

    want = jal.align(jframes[:2], poses[:2], jframes[2], pred, ref_data=jdata)
    got = tal.align(tframes[:2], poses[:2], tframes[2], pred, ref_data=tdata)
    plain = tal.align(tframes[:2], poses[:2], tframes[2], pred)
    jcam = JCamera.create(FX, FX, CX, CY)
    built_j = jal.align_build(raw[2][0], raw[2][1], jcam, 3, jdata, poses[:2], pred, depth_scale=1 / 5000)
    built_t = tal.align_build(raw[2][0], raw[2][1], Camera.create(FX, FX, CX, CY, device="cpu"), 3, tdata,
                              poses[:2], pred, depth_scale=1 / 5000)
    for (pose_t, cov_t, ok_t), (pose_j, cov_j, ok_j) in [(got, want), (built_t[2:], built_j[2:])]:
        assert ok_t and ok_j
        assert _gap(pose_t, pose_j) < 1e-3
        assert _gap(pose_t, poses[2]) < 0.02  # ground truth
        np.testing.assert_allclose(cov_t, cov_j, rtol=1e-2, atol=1e-6 * np.abs(cov_j).max())
    np.testing.assert_array_equal(got[0], plain[0])  # cached data are the frames' own
    # align_build's frame and data are the frame build's and precompute's
    frame_t, data_t = built_t[:2]
    torch.testing.assert_close(frame_t.intensity[1], tframes[2].intensity[1], rtol=0, atol=1e-4)
    for a, b in zip(data_t[0], tic.precompute_frame(tframes[2], t_cfg)[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3)


def test_debug_images_match_jax(three_frames):
    poses, _, _, jframes, _ = three_frames
    rel = lie_np.relative(poses[0], poses[2])
    want = jaligner.debug_images(jframes[0], jframes[2], rel)
    tframes = [interop.frame_from_numpy(_np_tree(f), device="cpu") for f in (jframes[0], jframes[2])]
    got = taligner.debug_images(tframes[0], tframes[1], rel)
    assert set(got) == set(want) == {"image_warped", "residual", "visible_mask"}
    np.testing.assert_array_equal(got["visible_mask"], want["visible_mask"])
    assert 0.5 < got["visible_mask"].mean() < 1.0
    for k in ("image_warped", "residual"):
        assert got[k].shape == (H, W)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3)


def test_keyframe_selection_visible_map():
    """KeyFrameSelectionCustom: a new keyframe on a large translation or too
    few visible landmarks (KeyFrameSelection.cpp:30-54)."""
    cam = Camera.create(FX, FX, CX, CY, device="cpu")
    dummy = create_frame(torch.zeros(H, W), torch.ones(H, W), cam, n_levels=1)
    m = Map()
    sel = KeyFrameSelectionCustom(m, min_visible_points=2, max_translation=0.2)
    kf = HostFrame(frame=dummy, t_ns=0, pose=np.eye(4))
    lms = [Landmark(position=np.array([x, 0.0, 2.0])) for x in (-0.2, 0.0, 0.2)]
    kf.keypoints = np.zeros((3, 2), np.float32)
    kf.kp_landmark = np.array([lm.id for lm in lms])
    for i, lm in enumerate(lms):
        lm.observations[kf.id] = i
    m.insert(kf, is_keyframe=True)
    m.insert_points(lms)
    for xi, want in ((np.array([0.01, 0, 0, 0, 0, 0]), False), (np.array([0.5, 0, 0, 0, 0, 0]), True),
                     (np.array([0, 0, 0, 0, 1.2, 0]), True)):
        sel.update(HostFrame(frame=dummy, t_ns=1, pose=lie_np.exp(xi)))
        assert bool(sel.is_keyframe()) is want



def test_odometry_icp_with_its_aligner_matches_jax(three_frames):
    """OdometryIcp aligns each frame against the last one with the aligner
    it is given: the port's with the port's RgbdAligner against JAX's with
    JAX's."""
    poses, _, cfg, jframes, _ = three_frames
    t_cfg = interop.alignment_config_from_fields(dataclasses.asdict(cfg))
    jm, tm = JMap(), Map()
    jodo = JOdometryIcp(JRgbdAligner(cfg), jm)
    todo = OdometryIcp(taligner.RgbdAligner(t_cfg), tm)
    from vslam_tpu.odometry.map import HostFrame as JHostFrame

    for i, jf in enumerate(jframes):
        tf = interop.frame_from_numpy(_np_tree(jf), device="cpu")
        jh = JHostFrame(frame=jf, t_ns=i * DT_NS, pose=jodo.pose if jodo.pose is not None else np.eye(4))
        th = HostFrame(frame=tf, t_ns=i * DT_NS, pose=todo.pose if todo.pose is not None else np.eye(4))
        jodo.update(jh)
        todo.update(th)
        jh.pose, th.pose = jodo.pose, todo.pose
        jm.insert(jh)
        tm.insert(th)
        assert _gap(todo.pose, jodo.pose) < 1e-3
        np.testing.assert_allclose(todo.speed, jodo.speed, rtol=0, atol=3e-2)
    assert _gap(todo.pose, poses[2]) < 0.02
