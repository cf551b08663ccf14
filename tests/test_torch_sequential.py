"""The port's sequential odometry (`vslam_tpu_torch.odometry.sequential`)
against the JAX package's, on one stream.

Stream: 8 frames of `smooth_trajectory` at 96x128 (fx 110), 30 Hz, in the
sensor dtypes (uint8 intensity, uint16 depth at 1/5000 m), chunk 4, so the
second chunk is short (the JAX scan pads it). Three configs on the `gather` sampler: quadratic,
Huber, and the Kalman prediction model. Tolerances: per-frame pose within
1e-3 (f32 chains, sums in another order), keyframe flags and `valid`
equal, covariance within rtol 1e-2 of its largest entry. Then the port
alone: `run_staged` equals `run`, chunking does not change the poses, and
a dead `live` slot passes the state through, and the `fused_gn` sampler
(its plain version on the CPU) tracks the stream.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vslam_tpu.alignment.ic import AlignmentConfig as JAlignmentConfig
from vslam_tpu.core.camera import Camera as JCamera
from vslam_tpu.odometry import sequential as jseq
from vslam_tpu.solvers import LossConfig as JLossConfig
from vslam_tpu.solvers import SolverConfig as JSolverConfig
from vslam_tpu_torch import interop
from vslam_tpu_torch.core import lie_np
from vslam_tpu_torch.core.camera import Camera
from vslam_tpu_torch.eval import metrics
from vslam_tpu_torch.io import synthetic
from vslam_tpu_torch.odometry import sequential as tseq
from vslam_tpu_torch.utils.tree import tree_map

H, W, FX = 96, 128, 110.0
N_FRAMES = 8
CHUNK = 4
DT_NS = int(1e9 / 30)
CX, CY = (W - 1) / 2, (H - 1) / 2

BASE = jseq.SequentialConfig(
    alignment=JAlignmentConfig(
        min_gradient=10.0,
        solver=JSolverConfig(max_iterations=50, min_step_size=1e-7),
        include_prior=True,
        prior_weight=(FX / 525.0) ** 2,
    ),
    depth_scale=1.0 / 5000.0,
    n_levels=3,
    kf_period=3,  # two keyframe switches inside 8 frames
)
CONFIGS = {
    "quadratic": BASE,
    "huber": dataclasses.replace(BASE, alignment=dataclasses.replace(
        BASE.alignment, loss=JLossConfig("Huber"))),
    "kalman": dataclasses.replace(BASE, prediction_model="Kalman"),
}


@pytest.fixture(scope="module")
def stream():
    K = synthetic.camera_matrix(FX, FX, CX, CY)
    poses = synthetic.smooth_trajectory(N_FRAMES, trans_amp=0.08, rot_amp=0.03)
    p0i = lie_np.inv(poses[0])
    poses = [p @ p0i for p in poses]
    items = []
    for i, p in enumerate(poses):
        inten, depth = synthetic.render(K, p, (H, W))
        items.append((i * DT_NS, np.clip(np.round(inten), 0, 255).astype(np.uint8),
                      np.clip(np.round(depth * 5000.0), 0, 65535).astype(np.uint16)))
    return poses, items


def _ate(poses, results):
    gt = {i * DT_NS / 1e9: lie_np.inv(p) for i, p in enumerate(poses)}
    est = {t / 1e9: lie_np.inv(p) for t, p, _ in results}
    ate, n = metrics.ate_rmse(gt, est)
    assert n == len(poses)
    return ate


def _port(cfg, chunk=CHUNK):
    return tseq.SequentialOdometry(Camera.create(FX, FX, CX, CY),
                                   interop.sequential_config_from_fields(dataclasses.asdict(cfg)),
                                   chunk=chunk)


def _jax_run(cfg, items):
    """JAX trajectory from `SequentialOdometry.run`, and per-frame valid and
    keyframe flags from the same `scan_odometry` programs driven chunk by
    chunk (the JAX driver keeps no per-frame flags)."""
    camera = JCamera.create(FX, FX, CX, CY)
    results = jseq.SequentialOdometry(camera, cfg, chunk=CHUNK).run(iter(items))
    first, chunks = jseq.stage_stream(iter(items), CHUNK)
    state = jseq.init_state(first[1], first[2], camera, cfg)
    valid, is_kf = [True], [True]
    for sc in chunks:
        state, _, v, _, k = jseq.scan_odometry(state, sc.intensity, sc.depth, sc.dts, sc.live,
                                               camera, cfg)
        valid += np.asarray(v)[: sc.n].tolist()
        is_kf += np.asarray(k)[: sc.n].tolist()
    return results, valid, is_kf


@pytest.mark.parametrize("name", list(CONFIGS))
def test_run_matches_jax(stream, name):
    poses, items = stream
    cfg = CONFIGS[name]
    j_results, j_valid, j_kf = _jax_run(cfg, items)
    odo = _port(cfg)
    t_results = odo.run(iter(items))
    assert [t for t, _, _ in t_results] == [t for t, _, _ in j_results]
    assert odo.valid == j_valid and all(odo.valid)
    assert odo.is_kf == j_kf and sum(odo.is_kf) >= 3
    for (_, Tt, ct), (_, Tj, cj) in zip(t_results, j_results):
        assert np.linalg.norm(lie_np.log(lie_np.relative(Tt, Tj))) < 1e-3
        np.testing.assert_allclose(ct, cj, rtol=1e-2, atol=1e-2 * np.abs(cj).max())
    np.testing.assert_array_equal(t_results[0][1], np.eye(4))
    np.testing.assert_array_equal(t_results[0][2], np.eye(6))
    assert _ate(poses, t_results) < 0.01


def test_run_staged_equals_run(stream):
    _, items = stream
    odo = _port(CONFIGS["huber"])
    streamed = odo.run(iter(items))
    first, chunks = tseq.stage_stream(iter(items), CHUNK)
    assert [len(sc.stamps) for sc in chunks] == [4, 3] and chunks[1].depth.shape == (3, H, W)
    assert chunks[0].depth.dtype == torch.int16  # uint16 bits, widened on the device
    staged = odo.run_staged(first, chunks)
    for (ts, Ts, cs), (tr, Tr, cr) in zip(staged, streamed):
        assert ts == tr
        np.testing.assert_array_equal(Ts, Tr)
        np.testing.assert_array_equal(cs, cr)


@pytest.mark.parametrize("model", ["ConstantMotion", "NoMotion"])
def test_padded_final_chunk_gives_the_same_poses(stream, model):
    """Chunks of 4 (the last one short, padded in the JAX scan) and one
    chunk of 16 (7 frames) give the same trajectory."""
    _, items = stream
    cfg = dataclasses.replace(BASE, prediction_model=model)
    small = _port(cfg, chunk=4).run(iter(items))
    big = _port(cfg, chunk=16).run(iter(items))
    assert len(small) == len(big) == N_FRAMES
    for (t1, T1, _), (t2, T2, _) in zip(small, big):
        assert t1 == t2
        assert np.linalg.norm(lie_np.log(lie_np.relative(T1, T2))) < 1e-6


@pytest.mark.parametrize("loss,interpolation,budget", [("None", "bilinear", 0.01),
                                                       ("Huber", "nearest", 0.02)])
def test_fused_gn_tracks_the_stream(stream, loss, interpolation, budget):
    """The two profiles of the sequential path at this size: the whole-level
    GN (its plain version on CPU tensors), 2048 points, bf16 image copy;
    quadratic with bilinear sampling (the odometry gate, 0.01 m), and Huber
    with nearest sampling, whose pixel quantization drifts more (the robust
    profile's gate, 0.02 m)."""
    poses, items = stream
    cfg = dataclasses.replace(BASE, alignment=dataclasses.replace(
        BASE.alignment, sampler="fused_gn", image_dtype="bfloat16", max_points=2048,
        interpolation=interpolation, loss=JLossConfig(loss),
        solver=JSolverConfig(max_iterations=100, min_step_size=1e-11, min_relative_reduction=1e-4)))
    odo = _port(cfg)
    results = odo.run(iter(items))
    assert all(odo.valid)
    assert _ate(poses, results) < budget


def test_dead_slot_passes_the_state_through(stream):
    """A slot with live False leaves the state as it was and re-emits the
    last pose, flagged neither valid nor keyframe."""
    _, items = stream
    cfg = interop.sequential_config_from_fields(dataclasses.asdict(CONFIGS["kalman"]))
    cam = Camera.create(FX, FX, CX, CY)
    state0 = tseq.init_state(items[0][1], items[0][2], cam, cfg)
    sc = tseq._stage_chunk(items[1:3], items[0][0], "cpu")
    args = (sc.intensity[:, None], sc.depth[:, None], sc.dts[:, None])
    live = torch.tensor([[True], [False]])
    state, poses, valid, _, is_kf = tseq.scan_odometry(state0, *args, live, cam, cfg)
    ref, ref_poses, *_ = tseq.scan_odometry(state0, *(a[:1] for a in args), live[:1], cam, cfg)
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), state, ref)
    torch.testing.assert_close(poses.t[1], ref_poses.t[0], rtol=0, atol=0)
    assert valid[:, 0].tolist() == [True, False] and not bool(is_kf[1, 0])


def test_live_none_equals_all_live(stream):
    """`SequentialOdometry`'s unpadded chunks pass live None, which skips the selects;
    the result is that of an all-True mask, bit for bit."""
    _, items = stream
    cfg = interop.sequential_config_from_fields(dataclasses.asdict(CONFIGS["kalman"]))
    cam = Camera.create(FX, FX, CX, CY)
    state0 = tseq.init_state(items[0][1], items[0][2], cam, cfg)
    sc = tseq._stage_chunk(items[1:4], items[0][0], "cpu")
    args = (sc.intensity[:, None], sc.depth[:, None], sc.dts[:, None])
    masked = tseq.scan_odometry(state0, *args, torch.ones(3, 1, dtype=torch.bool), cam, cfg)
    unmasked = tseq.scan_odometry(state0, *args, None, cam, cfg)
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), masked, unmasked)


def test_scan_state_keeps_fixed_shapes(stream):
    """Cached level data of every frame has one point count per level, so
    keyframe selects need no host decision."""
    _, items = stream
    odo = _port(BASE)
    odo.run(iter(items[:2]))
    kf, last = odo.state.kf_data, odo.state.last_data
    for a, b in zip(kf, last):
        for x, y in zip(a, b):
            assert x.shape == y.shape and x.shape[0] == 1
