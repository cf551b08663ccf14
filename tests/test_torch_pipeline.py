"""The port's host pipeline, `OdometryPipeline`, against the JAX package's.

* On a 12-frame `smooth_trajectory` stream at 96x128 with the default
  `gather` config, strict and pipelined: per-frame poses within 1e-3 of
  JAX's, the same keyframe schedule, and strict against pipelined within
  2e-3 (f64 host chain against f32 device chain, as `tests/test_odometry.py`
  accepts).
* `fused_gn` (the whole-level kernel's plain version on the CPU): the
  pipeline against the port's `SequentialOdometry` with the same config,
  frame by frame within 1e-3 (the JAX Pallas kernel in interpret mode is
  too slow to run the pipeline through).
* The fallback on a textureless frame, mirroring `tests/test_odometry.py`.

Its parts (motion models, the aligner's cached paths, the keyframe policy,
`OdometryIcp`) are held in `tests/test_torch_odometry.py`.
"""


import numpy as np
import pytest

from vslam_tpu.config import PipelineConfig as JPipelineConfig
from vslam_tpu.core.camera import Camera as JCamera
from vslam_tpu.odometry.pipeline import OdometryPipeline as JOdometryPipeline
from vslam_tpu_torch.config import PipelineConfig
from vslam_tpu_torch.core import lie_np
from vslam_tpu_torch.core.camera import Camera
from vslam_tpu_torch.io import synthetic
from vslam_tpu_torch.odometry.pipeline import OdometryPipeline
from vslam_tpu_torch.odometry.sequential import SequentialConfig, SequentialOdometry
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

H, W, FX = 96, 128, 110.0
CX, CY = (W - 1) / 2, (H - 1) / 2
K = synthetic.camera_matrix(FX, FX, CX, CY)
DT_NS = int(1e9 / 30)
N_FRAMES = 12
BASE = dict(features_min_gradient=10.0, solver_max_iterations=50, solver_min_step_size=1e-7)


def _gap(a, b) -> float:
    return float(np.linalg.norm(lie_np.log(lie_np.relative(a, b))))


def _encode(inten, depth):
    return (np.clip(np.round(inten), 0, 255).astype(np.uint8),
            np.clip(np.round(depth * 5000.0), 0, 65535).astype(np.uint16))


@pytest.fixture(scope="module")
def stream():
    poses = synthetic.smooth_trajectory(N_FRAMES, trans_amp=0.08, rot_amp=0.03, seed=5)
    p0i = lie_np.inv(poses[0])
    poses = [p @ p0i for p in poses]
    return poses, [(i * DT_NS, *synthetic.render(K, p, (H, W))) for i, p in enumerate(poses)]


# ---------------------------------------------------------------------------
# the whole pipeline
# ---------------------------------------------------------------------------


def _kf_times(pipeline):
    return sorted(f.t_ns for f in pipeline.map.keyframes())


@pytest.fixture(scope="module")
def gather_runs(stream):
    """Strict and pipelined runs of both packages' pipelines, default
    gather config."""
    _, items = stream
    out = {}
    for pipelined in (False, True):
        jp = JOdometryPipeline(JCamera.create(FX, FX, CX, CY), JPipelineConfig(**BASE))
        tp = OdometryPipeline(Camera(FX, FX, CX, CY), PipelineConfig(**BASE), device="cpu")
        assert tp._pipelined_eligible() and jp._pipelined_eligible()
        out[pipelined] = (jp, jp.run(iter(items), pipelined=pipelined), tp, tp.run(iter(items), pipelined=pipelined))
    return out


@pytest.mark.parametrize("pipelined", [False, True], ids=["strict", "pipelined"])
def test_pipeline_matches_jax(stream, gather_runs, pipelined):
    poses, _ = stream
    jp, jtraj, tp, ttraj = gather_runs[pipelined]
    assert len(ttraj) == len(jtraj) == N_FRAMES
    assert [t for t, _ in ttraj.items()] == [t for t, _ in jtraj.items()]
    for (t, Tt), (_, Tj) in zip(ttraj.items(), jtraj.items()):
        assert _gap(Tt, Tj) < 1e-3, t
        np.testing.assert_allclose(ttraj.cov_at(t), jtraj.cov_at(t), rtol=1e-2,
                                   atol=1e-2 * np.abs(jtraj.cov_at(t)).max())
    assert _kf_times(tp) == _kf_times(jp) and len(_kf_times(tp)) >= 3
    gt = {i * DT_NS / 1e9: lie_np.inv(p) for i, p in enumerate(poses)}
    est = {t / 1e9: lie_np.inv(p) for t, p in ttraj.items()}
    from vslam_tpu_torch.eval import metrics

    assert metrics.ate_rmse(gt, est)[0] < 0.01


def test_strict_and_pipelined_agree(gather_runs):
    strict, pipelined = gather_runs[False][3], gather_runs[True][3]
    for (t, a), (_, b) in zip(strict.items(), pipelined.items()):
        assert _gap(a, b) < 2e-3, t
    assert _kf_times(gather_runs[False][2]) == _kf_times(gather_runs[True][2])


@pytest.mark.parametrize("loss", ["None", "Huber"])
def test_fused_gn_pipeline_matches_sequential(stream, loss):
    """The production profile on the whole-level kernel's plain version,
    frames in the sensor dtypes. The pipeline counts the keyframe period
    from the first frame and the scan from the last keyframe (as their JAX
    counterparts do), so the period is longer than the stream and both
    align against {frame 0, last}."""
    _, items = stream
    raw = [(t, *_encode(i, d)) for t, i, d in items]
    cfg = PipelineConfig(**BASE, sampler="fused_gn", image_dtype="bfloat16", features_max_points=2048,
                         loss_function=loss, keyframe_selection_idx_period=N_FRAMES + 1)
    seq = SequentialOdometry(Camera.create(FX, FX, CX, CY, device="cpu"),
                             SequentialConfig(alignment=cfg.alignment_config(), depth_scale=cfg.depth_scale,
                                              kf_period=cfg.keyframe_selection_idx_period), chunk=4)
    want = seq.run(iter(raw))
    for pipelined in (True, False):
        got = OdometryPipeline(Camera(FX, FX, CX, CY), cfg, device="cpu").run(iter(raw), pipelined=pipelined)
        assert [t for t, _ in got.items()] == [t for t, _, _ in want]
        for (t, Tp), (_, Ts, _) in zip(got.items(), want):
            assert _gap(Tp, Ts) < (1e-3 if pipelined else 2e-3), (pipelined, t)
    assert all(seq.valid)


def test_fallback_on_a_textureless_frame(stream):
    """An information-free frame (zero image, all depth invalid) does not
    stop the pipeline (tests/test_odometry.py:108-125). Frame 4 is it, and
    a keyframe (period 5), so it has no interest point: frame 5, whose
    references are frame 4 twice, cannot be aligned and keeps the
    constant-motion prediction (Odometry.cpp:52-56); frame 6 aligns against
    frame 5 again."""
    poses, items = stream
    pipeline = OdometryPipeline(Camera(FX, FX, CX, CY), PipelineConfig(**BASE), device="cpu")
    for i, (t_ns, inten, depth) in enumerate(items[:8]):
        if i == 4:
            inten, depth = np.zeros((H, W), np.float32), np.zeros((H, W), np.float32)
        pipeline.process_frame(t_ns, inten, depth)
    traj = [T for _, T in pipeline.trajectory.items()]
    assert len(traj) == 8 and all(np.isfinite(T).all() for T in traj)
    assert int(pipeline.map.keyframes()[0].level_data[0].n_constraints) == 0
    pred5 = lie_np.exp(lie_np.log(lie_np.relative(traj[3], traj[4]))) @ traj[4]
    assert _gap(traj[5], pred5) < 1e-9
    assert _gap(traj[7], traj[6]) < 0.05
