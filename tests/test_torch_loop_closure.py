"""The port's loop closure (`vslam_tpu_torch.features.loop_closure`) and
pose-graph backend (`vslam_tpu_torch.odometry.graph_backend`) against the
JAX package's.

Keyframes: 9 box-scene views at 120x160 along `loop_trajectory` (the last
view revisits the first), features extracted once by the port and handed
to both packages as numpy (with the same frame ids, which seed the RANSAC),
so the comparison isolates the database and the graph. Tolerances:
* `estimate_rel_3d3d`: bit for bit (numpy, the same seed);
* `KeyframeDatabase.query`: the same candidate keyframe and inlier count,
  the relative transform, information and sigma_t bit for bit (the
  descriptor distances are integers and the RANSAC is the same numpy);
* `PoseGraphBackend.try_close`: the same closures and fold decisions, the
  corrected keyframe poses within 1e-4 (f32 graph solves), the keyframe
  trajectory's stamps equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.core.camera import Camera as JCamera
from vslam_tpu.core.frame import create_frame as jcreate_frame
from vslam_tpu.features import loop_closure as jlc
from vslam_tpu.odometry import graph_backend as jgb
from vslam_tpu.odometry import map as jmap
from vslam_tpu_torch.core import lie_np
from vslam_tpu_torch.core.camera import Camera
from vslam_tpu_torch.core.frame import create_frame
from vslam_tpu_torch.features import loop_closure as tlc
from vslam_tpu_torch.features.tracking import FeatureTracking
from vslam_tpu_torch.io import synthetic
from vslam_tpu_torch.odometry import graph_backend as tgb
from vslam_tpu_torch.odometry import map as tmap
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

H, W, FX = 120, 160, 140.0
CX, CY = (W - 1) / 2, (H - 1) / 2
N_KF = 9
CFG = dict(min_gap=3, min_matches=10, min_inliers=8)


@pytest.fixture(scope="module")
def keyframes():
    """(poses, per keyframe (keypoints, descriptors, kp_depth)) from the port's extraction."""
    K = synthetic.camera_matrix(FX, FX, CX, CY)
    poses = synthetic.loop_trajectory(N_KF, extent=0.3, height=0.05, yaw=0.2)
    scene = synthetic.BoxScene(seed=4)
    ft = FeatureTracking(grid_cell=16, device="cpu")
    cam = Camera.create(FX, FX, CX, CY, device="cpu")
    feats = []
    for p in poses:
        inten, depth = synthetic.render_boxes(K, p, (H, W), scene)
        f = tmap.HostFrame(frame=create_frame(torch.from_numpy(np.round(inten).astype(np.float32)),
                                              torch.from_numpy(depth), cam, n_levels=1), t_ns=0, pose=np.eye(4))
        ft.extract(f)
        feats.append((f.keypoints, f.descriptors, f.kp_depth))
    return poses, feats


def _frames(keyframes, port: bool, drift: float = 0.0):
    """HostFrames (ids 100 + k) carrying the shared features, at poses with
    a drift growing along the loop."""
    poses, feats = keyframes
    if port:
        dummy = create_frame(torch.zeros(8, 8), torch.ones(8, 8), Camera.create(FX, FX, CX, CY, device="cpu"),
                             n_levels=1)
        HostFrame = tmap.HostFrame
    else:
        dummy = jcreate_frame(jnp.zeros((8, 8)), jnp.ones((8, 8)), JCamera.create(FX, FX, CX, CY), n_levels=1)
        HostFrame = jmap.HostFrame
    out = []
    for k, (p, (kp, desc, z)) in enumerate(zip(poses, feats)):
        pose = lie_np.exp(np.array([drift * k, 0.0, 0.0, 0.0, 0.3 * drift * k, 0.0])) @ p
        f = HostFrame(frame=dummy, t_ns=1000 * k, pose=pose, id=100 + k)
        f.keypoints, f.descriptors, f.kp_depth = kp.copy(), desc.copy(), z.copy()
        f.kp_landmark = np.full(len(kp), -1, np.int64)
        out.append(f)
    return out


def test_estimate_rel_3d3d_bit_for_bit():
    rng = np.random.default_rng(9)
    p_old = rng.uniform(-1, 1, (60, 3)) + [0, 0, 3]
    T = lie_np.exp(np.array([0.1, -0.05, 0.02, 0.02, 0.1, -0.03]))
    p_new = p_old @ T[:3, :3].T + T[:3, 3] + rng.normal(0, 0.005, (60, 3))
    p_new[::7] += rng.normal(0, 0.5, p_new[::7].shape)  # outliers
    p_old[3] = np.nan  # a non-finite point
    for seed in (0, 101):
        Tt, it = tlc.estimate_rel_3d3d(p_old, p_new, seed=seed)
        Tj, ij = jlc.estimate_rel_3d3d(p_old, p_new, seed=seed)
        np.testing.assert_array_equal(Tt, Tj)
        np.testing.assert_array_equal(it, ij)
        assert it.sum() >= 40


def test_keyframe_database_query_matches_jax(keyframes):
    dbs = {}
    for port in (False, True):
        frames = _frames(keyframes, port)
        db = tlc.KeyframeDatabase(tlc.LoopClosureConfig(**CFG), device="cpu") if port else \
            jlc.KeyframeDatabase(jlc.LoopClosureConfig(**CFG))
        answers = []
        for f in frames:
            db.add(f)
            answers.append(db.query(f))
        dbs[port] = answers
    assert [a is None for a in dbs[True]] == [a is None for a in dbs[False]]
    assert dbs[True][-1] is not None and dbs[True][-1].kf_id in (100, 101)
    for got, want in zip(dbs[True], dbs[False]):
        if want is None:
            continue
        assert (got.kf_id, got.n_inliers) == (want.kf_id, want.n_inliers)
        np.testing.assert_array_equal(got.rel, want.rel)
        np.testing.assert_array_equal(got.info, want.info)
        assert got.sigma_t == want.sigma_t


def test_pose_graph_backend_try_close_matches_jax(keyframes):
    out = {}
    for port in (False, True):
        frames = _frames(keyframes, port, drift=0.004)
        cfg = (tlc if port else jlc).LoopClosureConfig(**CFG)
        gb = tgb.PoseGraphBackend(cfg, device="cpu") if port else jgb.PoseGraphBackend(cfg)
        corrections, significant = [], []
        for f in frames:
            gb.add_keyframe(f)
            corrections.append(gb.try_close(f))
            significant.append(gb.last_closure_significant)
        out[port] = (gb, corrections, significant)
    (tg, tc, ts), (jg, jc, js) = out[True], out[False]
    assert tg.n_closures == jg.n_closures >= 1
    assert ts == js
    assert [c is None for c in tc] == [c is None for c in jc]
    for got, want in zip(tc, jc):
        if want is None:
            continue
        assert got.keys() == want.keys()
        for fid in want:
            assert np.linalg.norm(lie_np.log(lie_np.relative(got[fid], want[fid]))) < 1e-4
    assert [t for t, _ in tg.keyframe_trajectory()] == [t for t, _ in jg.keyframe_trajectory()]
    assert tg.last_solve_nodes == jg.last_solve_nodes == N_KF
