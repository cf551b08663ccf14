"""The mapping backend through the port's other entry points, against the
JAX package's: `OdometryPipeline` with `enable_mapping` and
`enable_loop_closure`, `MultiSequenceOdometry(mappings=)` and the CLI's
`synthetic --mapping`.

Streams at 96x128 (fx 110), 30 Hz, from `smooth_trajectory` with fixed
seeds; the JAX scans run the `gather` sampler. Tolerances:
* pipeline (12 frames, keyframes every 3): per-frame poses within 1e-3 of
  JAX's, the same keyframes and landmark count (mapping), the same
  closure count (loop closure);
* suite (S = 2, 10 and 8 frames, chunk 4), sync and async: each
  sequence's poses within 1e-3 of JAX's, the same landmark counts;
* CLI `synthetic --mapping` host loop and `--fused`: the same frames and
  landmarks, the ATE within 1e-3 m of the JAX CLI's and below 0.01 m;
* the stereo scan with the backend (`test_torch_kitti.py`'s 8-frame stereo
  stream, chunk 4, synchronous): poses within 1e-3 of JAX's and landmark
  counts within 10 % (the keypoints' depth is block-matched, and the port's
  block matcher is held to the jitted JAX one only to 1e-4 px).
"""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest

from vslam_tpu.alignment.ic import AlignmentConfig as JAlignmentConfig
from vslam_tpu.config import PipelineConfig as JPipelineConfig
from vslam_tpu.core.camera import Camera as JCamera
from vslam_tpu.eval.evaluate import main as jax_main
from vslam_tpu.odometry import sequential as jseq
from vslam_tpu.odometry import sequential_mapping as jsm
from vslam_tpu.odometry.pipeline import OdometryPipeline as JOdometryPipeline
from vslam_tpu.parallel import sequences as jmseq
from vslam_tpu.solvers import SolverConfig as JSolverConfig
from vslam_tpu_torch import interop
from vslam_tpu_torch.config import PipelineConfig
from vslam_tpu_torch.core import lie_np
from vslam_tpu_torch.core.camera import Camera
from vslam_tpu_torch.eval.evaluate import main as port_main
from vslam_tpu_torch.io import synthetic
from vslam_tpu_torch.odometry import sequential as tseq
from vslam_tpu_torch.odometry import sequential_mapping as tsm
from vslam_tpu_torch.odometry.pipeline import OdometryPipeline
from vslam_tpu_torch.parallel import sequences as tmseq
import test_torch_kitti as kitti_tests
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

H, W, FX = 96, 128, 110.0
CX, CY = (W - 1) / 2, (H - 1) / 2
K = synthetic.camera_matrix(FX, FX, CX, CY)
DT_NS = int(1e9 / 30)
BASE = dict(features_min_gradient=10.0, solver_max_iterations=50, solver_min_step_size=1e-7,
            keyframe_selection_idx_period=3)


def _gap(a, b) -> float:
    return float(np.linalg.norm(lie_np.log(lie_np.relative(np.asarray(a), np.asarray(b)))))


def _stream(n, seed, encode=False):
    poses = synthetic.smooth_trajectory(n, trans_amp=0.06, rot_amp=0.02, seed=seed)
    p0i = lie_np.inv(poses[0])
    poses = [p @ p0i for p in poses]
    items = []
    for i, p in enumerate(poses):
        inten, depth = synthetic.render(K, p, (H, W))
        if encode:
            inten = np.clip(np.round(inten), 0, 255).astype(np.uint8)
            depth = np.clip(np.round(depth * 5000.0), 0, 65535).astype(np.uint16)
        items.append((i * DT_NS, inten, depth))
    return poses, items


@pytest.mark.parametrize("option", ["enable_mapping", "enable_loop_closure"])
def test_pipeline_mapping_matches_jax(option):
    poses, items = _stream(12, seed=5)
    jp = JOdometryPipeline(JCamera.create(FX, FX, CX, CY), JPipelineConfig(**BASE, **{option: True}))
    tp = OdometryPipeline(Camera(FX, FX, CX, CY), PipelineConfig(**BASE, **{option: True}), device="cpu")
    assert not tp._pipelined_eligible()
    jtraj, ttraj = jp.run(iter(items)), tp.run(iter(items))
    assert [t for t, _ in ttraj.items()] == [t for t, _ in jtraj.items()]
    for (_, Tt), (_, Tj) in zip(ttraj.items(), jtraj.items()):
        assert _gap(Tt, Tj) < 1e-3
    assert sorted(f.t_ns for f in tp.map.keyframes()) == sorted(f.t_ns for f in jp.map.keyframes())
    assert len(tp.map.points()) == len(jp.map.points())
    if option == "enable_mapping":
        assert len(tp.map.points()) > 0
    else:
        assert tp._graph.n_closures == jp._graph.n_closures
        assert len(tp._graph.kf_ids) == len(jp._graph.kf_ids) >= 4
    errs = [_gap(T, poses[i]) for i, (_, T) in enumerate(ttraj.items())]
    assert np.mean(errs) < 0.01


JCFG = jseq.SequentialConfig(
    alignment=JAlignmentConfig(min_gradient=10.0, solver=JSolverConfig(max_iterations=50, min_step_size=1e-7),
                               include_prior=True),
    depth_scale=1.0 / 5000.0, n_levels=3, kf_period=3)
TCFG = interop.sequential_config_from_fields(dataclasses.asdict(JCFG))


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_suite_mappings_match_jax(mode):
    streams = [_stream(10, seed=5, encode=True)[1], _stream(8, seed=9, encode=True)[1]]
    jb = [jsm.ChunkMappingBackend(enable_ba=True) for _ in streams]
    tb = [tsm.ChunkMappingBackend(enable_ba=True, device="cpu") for _ in streams]
    jres = jmseq.MultiSequenceOdometry([JCamera.create(FX, FX, CX, CY)] * 2, JCFG, chunk=4, mappings=jb,
                                       async_mapping=(mode == "async")).run(streams)
    tres = tmseq.MultiSequenceOdometry([Camera.create(FX, FX, CX, CY, device="cpu")] * 2, TCFG, chunk=4,
                                       mappings=tb, async_mapping=(mode == "async")).run(streams)
    for s in range(2):
        assert len(tres[s]) == len(jres[s]) == len(streams[s])
        for (t1, T1, _), (t2, T2, _) in zip(tres[s], jres[s]):
            assert t1 == t2 and _gap(T1, T2) < 1e-3
        assert tb[s].n_landmarks == jb[s].n_landmarks > 0
        assert tb[s].batched_track_chunks > 0


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
def test_cli_synthetic_mapping_matches_jax(fused):
    argv = ["synthetic", "--frames", "10", "--mapping"] + (["--fused"] if fused else [])
    want = _cli(jax_main, argv)
    got = _cli(port_main, argv + ["--device", "cpu"])
    assert got["frames"] == want["frames"] == 10
    assert got["landmarks"] == want["landmarks"] > 0
    assert abs(got["ate_rmse_m"] - want["ate_rmse_m"]) < 1e-3
    assert got["ate_rmse_m"] < 0.01


def test_stereo_mapping_matches_jax():
    """The stereo path of the backend: the keyframes' depth is block-matched
    again for detection, queued at the retire (the scan does not keep its
    depth)."""
    _, items = kitti_tests.stereo_stream()
    cam = (kitti_tests.FX, kitti_tests.FX, kitti_tests.CX, kitti_tests.CY)
    cfg = kitti_tests.STEREO_CFG
    jb = jsm.ChunkMappingBackend(enable_ba=True)
    jres = jseq.SequentialOdometry(JCamera.create(*cam), cfg, chunk=4, mapping=jb,
                                   async_mapping=False).run(iter(items))
    tb = tsm.ChunkMappingBackend(enable_ba=True, device="cpu")
    tres = tseq.SequentialOdometry(Camera.create(*cam, device="cpu"),
                                   interop.sequential_config_from_fields(dataclasses.asdict(cfg)), chunk=4,
                                   mapping=tb, async_mapping=False).run(iter(items))
    assert [t for t, _, _ in tres] == [t for t, _, _ in jres]
    for (_, T1, _), (_, T2, _) in zip(tres, jres):
        assert _gap(T1, T2) < 1e-3
    assert tb.batched_detect_chunks == tb.batched_track_chunks == 2
    assert abs(tb.n_landmarks - jb.n_landmarks) <= 0.1 * jb.n_landmarks and tb.n_landmarks > 0, (
        tb.n_landmarks, jb.n_landmarks)
