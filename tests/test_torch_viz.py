"""The port's live viewer (`vslam_tpu_torch.viz.live`) on the tests of
`tests/test_viz.py`, and against the JAX package's `LiveViz`.

Every viewer binds port 0, every request has a 5 s timeout and every
viewer is closed in `finally`. The fused-path tests run the port's
`SequentialOdometry` on the CPU at 96x128 (10 frames, chunk 4). Parity:
the same publish calls into both viewers give the same `state()` but for
`fps` (each takes its own wall clock), compared exactly: both are the same
numpy arithmetic.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from vslam_tpu.viz import LiveViz as JLiveViz
from vslam_tpu_torch.core import lie_np
from vslam_tpu_torch.viz import LiveViz
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

H, W, FX = 96, 128, 110.0


def _get(port: int, path: str) -> bytes:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        assert r.status == 200
        return r.read()


def test_publish_and_state_bus():
    viz = LiveViz(port=0)
    try:
        # world->cam poses walking +x in camera-in-world terms: with R = I
        # the w2c translation is -p
        for i in range(10):
            T = np.eye(4)
            T[:3, 3] = [-0.1 * i, 0.0, 0.0]
            viz.publish_odometry(int(i * 1e8), T, cov=np.eye(6) * 1e-4, twist=np.array([3.0, 0, 0, 0, 0, 0]))
        viz.publish_keyframe(0, np.eye(4))
        viz.publish_landmarks(np.random.default_rng(0).normal(size=(50, 3)))

        state = json.loads(_get(viz.port, "/state.json"))
        assert state["n_frames"] == 10
        assert state["n_keyframes"] == 1
        assert state["n_landmarks"] == 50
        assert np.isclose(state["path"][-1][0], 0.9)
        assert np.isclose(state["position"][0], 0.9)
        assert state["t_ns"] == int(9e8)
        assert np.isclose(state["sigma_translation"], np.sqrt(3e-4))
        assert np.isclose(state["speed"], 3.0)

        page = _get(viz.port, "/").decode()
        assert "state.json" in page and "<svg" in page
    finally:
        viz.close()


def test_display_inverts_w2c_pose():
    """The viewer shows camera-in-world, the inverse of the world->camera
    poses it is given (NodeMapping.cpp:238)."""
    viz = LiveViz(port=0)
    try:
        T_c2w = lie_np.exp(np.random.default_rng(1).normal(scale=0.3, size=6))
        viz.publish_odometry(0, np.linalg.inv(T_c2w))
        np.testing.assert_allclose(viz.state()["position"], T_c2w[:3, 3], atol=1e-9)
    finally:
        viz.close()


def test_path_ring_decimates():
    viz = LiveViz(port=0, max_path=64)
    try:
        for i in range(200):
            T = np.eye(4)
            T[0, 3] = float(i)
            viz.publish_odometry(i, T)
        state = viz.state()
        assert state["n_frames"] == 200
        assert len(state["path"]) <= 65
        assert state["n_landmarks"] == 0
    finally:
        viz.close()


def test_landmark_cap():
    viz = LiveViz(port=0, max_landmarks=16)
    try:
        viz.publish_landmarks(np.arange(300.0).reshape(100, 3))
        assert len(viz.state()["landmarks"]) == 16
    finally:
        viz.close()


def test_pipeline_wiring():
    """``live_viz_port`` starts the viewer and `_publish_viz`, which both
    trajectory-append sites call, feeds it."""
    from vslam_tpu_torch.config import PipelineConfig
    from vslam_tpu_torch.core.camera import Camera
    from vslam_tpu_torch.odometry.map import HostFrame
    from vslam_tpu_torch.odometry.pipeline import OdometryPipeline

    pipe = OdometryPipeline(Camera(525.0, 525.0, 319.5, 239.5), PipelineConfig(live_viz_port=0), device="cpu")
    try:
        assert pipe.viz is not None and pipe.viz.port > 0
        T = np.eye(4)
        T[2, 3] = -1.0
        pipe._publish_viz(42, HostFrame(frame=None, t_ns=42, pose=T, cov=np.eye(6) * 1e-6), is_kf=True)
        state = json.loads(_get(pipe.viz.port, "/state.json"))
        assert state["n_frames"] == 1 and state["n_keyframes"] == 1
        assert np.isclose(state["position"][2], 1.0)
    finally:
        pipe.viz.close()


def _stream(n=10):
    from vslam_tpu_torch.io import synthetic

    K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    poses = synthetic.smooth_trajectory(n, trans_amp=0.08, rot_amp=0.03)
    p0i = lie_np.inv(poses[0])
    return [(i * int(1e9 / 30), *synthetic.render(K, p @ p0i, (H, W))) for i, p in enumerate(poses)]


def _seq_odometry(**kw):
    from vslam_tpu_torch.alignment.ic import AlignmentConfig
    from vslam_tpu_torch.core.camera import Camera
    from vslam_tpu_torch.odometry.sequential import SequentialConfig, SequentialOdometry
    from vslam_tpu_torch.solvers import SolverConfig

    cfg = SequentialConfig(
        alignment=AlignmentConfig(min_gradient=10.0, solver=SolverConfig(max_iterations=50, min_step_size=1e-7),
                                  include_prior=True, prior_weight=(FX / 525.0) ** 2),
        n_levels=3,
        kf_period=5,
    )
    return SequentialOdometry(Camera.create(FX, FX, (W - 1) / 2, (H - 1) / 2, device="cpu"), cfg, chunk=4, **kw)


def test_fused_path_publishes_retired_chunks():
    """SequentialOdometry(viz=) publishes each retired chunk's frames and
    keyframes, the seed frame first, from the chunk's fetched poses."""
    viz = LiveViz(port=0)
    try:
        odo = _seq_odometry(viz=viz)
        results = odo.run(iter(_stream()))
        state = viz.state()
        assert state["n_frames"] == len(results) == 10
        assert state["n_keyframes"] == sum(odo.is_kf) >= 2  # the seed frame and kf_period 5
        t, T, _ = results[-1]
        assert state["t_ns"] == t
        np.testing.assert_allclose(state["position"], np.linalg.inv(T)[:3, 3], atol=1e-6)
        assert state["n_landmarks"] == 0
    finally:
        viz.close()


@pytest.mark.parametrize("async_mapping", [True, False], ids=["async", "sync"])
def test_fused_path_publishes_the_maps_landmarks(async_mapping):
    """With a mapping backend the viewer ends the run holding the map's
    landmarks: read by the worker after each of its jobs (async) or after
    each chunk's backend call (sync), never while the map is written."""
    from vslam_tpu_torch.odometry.sequential_mapping import ChunkMappingBackend

    viz = LiveViz(port=0)
    try:
        backend = ChunkMappingBackend(enable_ba=True, device="cpu")
        odo = _seq_odometry(viz=viz, mapping=backend, async_mapping=async_mapping)
        odo.run(iter(_stream()))
        state = viz.state()
        assert state["n_frames"] == 10
        assert state["n_landmarks"] == backend.n_landmarks > 0
        want = np.stack([p.position for p in backend.map.points()])
        np.testing.assert_array_equal(np.asarray(state["landmarks"]), want)
    finally:
        viz.close()


def test_unknown_path_404():
    viz = LiveViz(port=0)
    try:
        with pytest.raises(urllib.error.HTTPError):
            _get(viz.port, "/nope")
    finally:
        viz.close()


def test_state_equals_the_jax_viewers():
    """The same publish calls into the JAX package's viewer and the port's
    give equal states, every key but fps, exactly."""
    rng = np.random.default_rng(5)
    port, jax_viz = LiveViz(port=0, max_path=32, max_landmarks=64), JLiveViz(port=0, max_path=32, max_landmarks=64)
    try:
        for i in range(80):
            T = lie_np.exp(rng.normal(scale=0.2, size=6))
            cov = np.diag(rng.uniform(1e-6, 1e-3, 6))
            twist = rng.normal(size=6)
            for v in (port, jax_viz):
                v.publish_odometry(i * 1000, T, cov=cov, twist=twist, wall_time=0.01 * i)
                if i % 3 == 0:
                    v.publish_keyframe(i * 1000, T)
            if i % 20 == 19:
                pts = rng.normal(size=(100 + i, 3))
                for v in (port, jax_viz):
                    v.publish_landmarks(pts)
        a, b = port.state(), jax_viz.state()
        a.pop("fps"), b.pop("fps")
        assert a == b
        assert a["n_frames"] == 80 and len(a["path"]) <= 33 and len(a["landmarks"]) == 64
    finally:
        port.close()
        jax_viz.close()
