"""The port's mapping backend of the sequential scan (`vslam_tpu_torch.
odometry.sequential_mapping`, `SequentialOdometry(mapping=)`) against the
JAX package's, and `render_boxes_batch`.

Stream: 12 frames of `smooth_trajectory` at 96x128 (fx 110), 30 Hz, uint8
intensity and uint16 depth at 1/5000 m, keyframes every 3 frames, chunk 4;
the JAX scan runs the `gather` sampler (no interpreted Pallas kernel).
Tolerances:
* `anchor_trajectory`: bit for bit (numpy);
* `ChunkMappingBackend.process_chunk` driven directly (frame 0 on the
  per-keyframe path, then chunks of 4 on the batched path, at the true
  poses with a drift), for pose_write_back off, gated and always: the same
  keyframes, landmark count and associations, returned corrections within
  1e-4 (SE(3) log norm, f32 BA solves), landmark positions within 1e-4 m;
* `SequentialOdometry(mapping=)`, sync and async, against JAX: poses within
  1e-3 (the tolerance of `test_torch_sequential.py`), the same landmark
  count; two async runs of the port repeat to 1e-9;
* `render_boxes_batch` on the CPU within 1e-2 gray levels and 1e-5 m of the
  numpy `render_boxes` (f32 against f64), `loop_trajectory` bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.alignment.ic import AlignmentConfig as JAlignmentConfig
from vslam_tpu.core.camera import Camera as JCamera
from vslam_tpu.io import synthetic as jsynthetic
from vslam_tpu.odometry import sequential as jseq
from vslam_tpu.odometry import sequential_mapping as jsm
from vslam_tpu.solvers import SolverConfig as JSolverConfig
from vslam_tpu_torch import interop
from vslam_tpu_torch.core import lie_np
from vslam_tpu_torch.core.camera import Camera
from vslam_tpu_torch.io import synthetic
from vslam_tpu_torch.odometry import sequential as tseq
from vslam_tpu_torch.odometry import sequential_mapping as tsm
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

H, W, FX = 96, 128, 110.0
CX, CY = (W - 1) / 2, (H - 1) / 2
N_FRAMES = 12
CHUNK = 4
DT_NS = int(1e9 / 30)

CFG = jseq.SequentialConfig(
    alignment=JAlignmentConfig(min_gradient=10.0, solver=JSolverConfig(max_iterations=50, min_step_size=1e-7),
                               include_prior=True),
    depth_scale=1.0 / 5000.0,
    n_levels=3,
    kf_period=3,
)
TCFG = interop.sequential_config_from_fields(dataclasses.asdict(CFG))


@pytest.fixture(scope="module")
def stream():
    K = synthetic.camera_matrix(FX, FX, CX, CY)
    poses = synthetic.smooth_trajectory(N_FRAMES, trans_amp=0.06, rot_amp=0.02)
    p0i = lie_np.inv(poses[0])
    poses = [p @ p0i for p in poses]
    items = []
    for i, p in enumerate(poses):
        inten, depth = synthetic.render(K, p, (H, W))
        items.append((i * DT_NS, np.clip(np.round(inten), 0, 255).astype(np.uint8),
                      np.clip(np.round(depth * 5000.0), 0, 65535).astype(np.uint16)))
    return poses, items


def _gap(a, b):
    return np.linalg.norm(lie_np.log(lie_np.relative(np.asarray(a), np.asarray(b))))


def test_anchor_trajectory_bit_for_bit():
    rng = np.random.default_rng(4)
    results = [(i * 10, lie_np.exp(rng.normal(0, 0.1, 6)), np.eye(6)) for i in range(9)]
    kf = [(t, lie_np.exp(rng.normal(0, 0.1, 6))) for t in (0, 30, 60, 75)]  # 75 is no output stamp
    for (t1, T1, _), (t2, T2, _) in zip(tsm.anchor_trajectory(results, kf), jsm.anchor_trajectory(results, kf)):
        assert t1 == t2
        np.testing.assert_array_equal(T1, T2)
    assert tsm.anchor_trajectory(results, []) is results


def _drive_backend(backend, items, poses, port: bool):
    """Frame 0, then chunks of 4 with keyframes every 3 frames, at the true
    poses with a drift; returns each call's correction."""
    cam = Camera.create(FX, FX, CX, CY, device="cpu") if port else JCamera.create(FX, FX, CX, CY)
    cfg = TCFG if port else CFG
    drifted = [lie_np.exp(np.array([0.002 * i, 0.0, 0.0, 0.0, 0.001 * i, 0.0])) @ p for i, p in enumerate(poses)]
    deltas = [backend.process_chunk([items[0]], [np.eye(4)], [np.eye(6)], [True], cam, cfg)]
    for s in range(1, N_FRAMES, CHUNK):
        buf = items[s : s + CHUNK]
        inten = np.stack([i for _, i, _ in buf])
        depth = np.stack([d for _, _, d in buf])
        if port:
            images = (torch.from_numpy(inten), torch.from_numpy(depth.view(np.int16)))
        else:
            images = (jnp.asarray(inten), jnp.asarray(depth))
        flags = [(s + j) % 3 == 0 for j in range(len(buf))]
        deltas.append(backend.process_chunk(buf, drifted[s : s + CHUNK], [np.eye(6)] * len(buf), flags, cam, cfg,
                                            device_images=images))
    return deltas


def _canonical(frames):
    names = {}
    return [[-1 if x < 0 else names.setdefault(int(x), len(names)) for x in f.kp_landmark] for f in frames]


@pytest.mark.parametrize("mode", ["off", "gated", "always"])
def test_process_chunk_matches_jax(stream, mode):
    poses, items = stream
    jb = jsm.ChunkMappingBackend(enable_ba=True, pose_write_back=mode)
    tb = tsm.ChunkMappingBackend(enable_ba=True, pose_write_back=mode, device="cpu")
    jd = _drive_backend(jb, items, poses, port=False)
    td = _drive_backend(tb, items, poses, port=True)
    assert tb.batched_detect_chunks == tb.batched_track_chunks == 3
    assert [d is None for d in td] == [d is None for d in jd]
    for got, want in zip(td, jd):
        if want is not None:
            assert _gap(got, want) < 1e-4
    assert tb.n_landmarks == jb.n_landmarks > 0
    assert _canonical(tb.map.keyframes()) == _canonical(jb.map.keyframes())
    pj = np.asarray(sorted(tuple(p.position) for p in jb.map.points()))
    pt = np.asarray(sorted(tuple(p.position) for p in tb.map.points()))
    np.testing.assert_allclose(pt, pj, atol=1e-4)


@pytest.fixture(scope="module")
def jax_runs(stream):
    _, items = stream
    cam = JCamera.create(FX, FX, CX, CY)
    out = {}
    for mode in ("sync", "async"):
        backend = jsm.ChunkMappingBackend(enable_ba=True)
        res = jseq.SequentialOdometry(cam, CFG, chunk=CHUNK, mapping=backend,
                                      async_mapping=(mode == "async")).run(iter(items))
        out[mode] = (res, backend.n_landmarks)
    return out


def _port_run(items, mode, **kw):
    backend = tsm.ChunkMappingBackend(enable_ba=True, device="cpu", **kw)
    odo = tseq.SequentialOdometry(Camera.create(FX, FX, CX, CY, device="cpu"), TCFG, chunk=CHUNK, mapping=backend,
                                  async_mapping=(mode == "async"))
    return odo.run(iter(items)), backend


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_sequential_mapping_matches_jax(stream, jax_runs, mode):
    poses, items = stream
    res, backend = _port_run(items, mode)
    want, n_landmarks = jax_runs[mode]
    assert len(res) == len(want) == N_FRAMES
    for (t1, T1, _), (t2, T2, _) in zip(res, want):
        assert t1 == t2
        assert _gap(T1, T2) < 1e-3
    assert backend.n_landmarks == n_landmarks > 0
    assert np.mean([_gap(T, poses[i]) for i, (_, T, _) in enumerate(res)]) < 0.01
    if mode == "async":
        again, _ = _port_run(items, mode)
        for (_, T1, _), (_, T2, _) in zip(res, again):
            np.testing.assert_allclose(T1, T2, atol=1e-9)


def test_sequential_mapping_staged_and_compute_device(stream):
    """`run_staged` drives the backend as `run` does, and compute_device
    "default" (everything on the scan's device, here the CPU) as "auto"."""
    _, items = stream
    res, _ = _port_run(items, "sync")
    cam = Camera.create(FX, FX, CX, CY, device="cpu")
    first, chunks = tseq.stage_stream(iter(items), CHUNK, device="cpu")
    for kw in ({}, {"compute_device": "default"}):
        odo = tseq.SequentialOdometry(cam, TCFG, chunk=CHUNK, async_mapping=False,
                                      mapping=tsm.ChunkMappingBackend(enable_ba=True, device="cpu", **kw))
        for (_, T1, _), (_, T2, _) in zip(res, odo.run_staged(first, chunks)):
            np.testing.assert_allclose(T1, T2, atol=1e-9)


def test_render_boxes_batch_matches_host():
    Kc = synthetic.camera_matrix(100.0, 100.0, (W - 1) / 2, (H - 1) / 2)
    scene = synthetic.BoxScene(seed=4, scale=5.0, background=synthetic.PlaneScene(
        normal=(0.0, -0.25, 1.0), d=12.5, origin=(0.0, 0.0, 12.5)))
    poses = synthetic.loop_trajectory(5, extent=2.0, height=0.1, yaw=0.2)
    for want, got in zip(jsynthetic.loop_trajectory(5, extent=2.0, height=0.1, yaw=0.2), poses):
        np.testing.assert_array_equal(got, want)
    for sc in (synthetic.BoxScene(seed=4), scene):
        inten, depth = synthetic.render_boxes_batch(Kc, poses, (H, W), sc, batch=2, device="cpu")
        only_i, none = synthetic.render_boxes_batch(Kc, poses[:1], (H, W), sc, with_depth=False, device="cpu")
        assert inten.shape == depth.shape == (5, H, W) and none is None
        np.testing.assert_allclose(only_i[0], inten[0], atol=1e-2, rtol=0)
        for i, p in enumerate(poses):
            ih, dh = synthetic.render_boxes(Kc, p, (H, W), sc)
            np.testing.assert_allclose(inten[i], ih, atol=1e-2, rtol=0)
            np.testing.assert_allclose(depth[i], dh, atol=1e-5, rtol=1e-6)
