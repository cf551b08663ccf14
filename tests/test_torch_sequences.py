"""The port's suite mode (`vslam_tpu_torch.parallel.sequences`) against the
JAX package's `vslam_tpu.parallel.sequences`, on the same streams.

Streams: two sequences at 96x128, 30 Hz, in the sensor dtypes (uint8
intensity, uint16 depth at 1/5000 m): 9 frames of the plane scene (seed 0,
fx 110) and 6 frames of another scene (seed 3) seen with fx 137.5, so the
lengths are ragged and the intrinsics differ per sequence. Chunk 4, the
`gather` sampler (the JAX `fused_gn` kernel runs seconds a call in interpret
mode). Tolerances, those of `tests/test_torch_sequential.py`: per-frame pose
within 1e-3 (SE(3) log), covariance within rtol 1e-2 of its largest entry,
`valid` and keyframe flags equal; the first states' cached level data within
1e-4 (points, templates) and 1e-2 relative (Jacobians), masks equal;
`_fold_corrections` within 1e-6. The port alone: `run_staged` equals `run`
bit for bit, a suite of two identical streams equals the single-sequence
port run within 1e-6, and the short sequence of the ragged suite equals its
own single-sequence run within 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.alignment.ic import AlignmentConfig as JAlignmentConfig
from vslam_tpu.core.camera import Camera as JCamera
from vslam_tpu.odometry import sequential as jseq
from vslam_tpu.parallel import sequences as jmseq
from vslam_tpu.solvers import SolverConfig as JSolverConfig
from vslam_tpu_torch import interop
from vslam_tpu_torch.core import lie_np
from vslam_tpu_torch.core.camera import Camera
from vslam_tpu_torch.eval import metrics
from vslam_tpu_torch.io import synthetic
from vslam_tpu_torch.odometry import sequential as tseq
from vslam_tpu_torch.parallel import sequences as tmseq
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

H, W, FX = 96, 128, 110.0
FX2 = FX * 1.25
CX, CY = (W - 1) / 2, (H - 1) / 2
DT_NS = int(1e9 / 30)
CHUNK = 4
LENGTHS = (9, 6)

JCFG = jseq.SequentialConfig(
    alignment=JAlignmentConfig(
        min_gradient=10.0,
        solver=JSolverConfig(max_iterations=50, min_step_size=1e-7),
        include_prior=True,
        prior_weight=(FX / 525.0) ** 2,
    ),
    depth_scale=1.0 / 5000.0,
    n_levels=3,
    kf_period=5,
)
CFG = interop.sequential_config_from_fields(dataclasses.asdict(JCFG))


def _stream(n, seed, fx):
    K = synthetic.camera_matrix(fx, fx, CX, CY)
    scene = synthetic.default_scene(seed=seed)
    poses = synthetic.smooth_trajectory(n, trans_amp=0.08, rot_amp=0.03)
    p0i = lie_np.inv(poses[0])
    poses = [p @ p0i for p in poses]
    items = []
    for i, p in enumerate(poses):
        inten, depth = synthetic.render(K, p, (H, W), scene)
        items.append((i * DT_NS, np.clip(np.round(inten), 0, 255).astype(np.uint8),
                      np.clip(np.round(depth * 5000.0), 0, 65535).astype(np.uint16)))
    return poses, items


@pytest.fixture(scope="module")
def suite():
    """[(poses, items, fx)] of the two sequences."""
    return [(*_stream(LENGTHS[0], 0, FX), FX), (*_stream(LENGTHS[1], 3, FX2), FX2)]


def _jcams(suite):
    return [JCamera.create(fx, fx, CX, CY) for _, _, fx in suite]


def _tcams(suite):
    return [Camera.create(fx, fx, CX, CY, device="cpu") for _, _, fx in suite]


@pytest.fixture(scope="module")
def jax_results(suite):
    """The JAX driver's `run` and `run_staged` on the suite."""
    odo = jmseq.MultiSequenceOdometry(_jcams(suite), JCFG, chunk=CHUNK)
    streams = [items for _, items, _ in suite]
    run = odo.run([iter(s) for s in streams])
    firsts, chunks = odo.stage_streams([iter(s) for s in streams])
    return run, odo.run_staged(firsts, chunks)


@pytest.fixture(scope="module")
def port_results(suite):
    odo = tmseq.MultiSequenceOdometry(_tcams(suite), CFG, chunk=CHUNK)
    streams = [items for _, items, _ in suite]
    run = odo.run([iter(s) for s in streams])
    firsts, chunks = odo.stage_streams([iter(s) for s in streams])
    return run, odo.run_staged(firsts, chunks), chunks


def _assert_trajectories_close(got, want, tol=1e-3, cov=True):
    assert [t for t, _, _ in got] == [t for t, _, _ in want]
    for (_, Tt, ct), (_, Tj, cj) in zip(got, want):
        assert np.linalg.norm(lie_np.log(lie_np.relative(Tt, Tj))) < tol
        if cov:
            np.testing.assert_allclose(ct, cj, rtol=1e-2, atol=1e-2 * np.abs(cj).max())


def _ate(poses, results):
    gt = {i * DT_NS / 1e9: lie_np.inv(p) for i, p in enumerate(poses)}
    est = {t / 1e9: lie_np.inv(p) for t, p, _ in results}
    ate, n = metrics.ate_rmse(gt, est)
    assert n == len(poses)
    return ate


@pytest.mark.parametrize("which", ["run", "run_staged"])
def test_driver_matches_jax(suite, jax_results, port_results, which):
    """Ragged lengths (9 and 6) and per-sequence intrinsics, each sequence's
    trajectory against JAX's."""
    k = ("run", "run_staged").index(which)
    got, want = port_results[k], jax_results[k]
    assert [len(r) for r in got] == list(LENGTHS)
    for s, (poses, _, _) in enumerate(suite):
        _assert_trajectories_close(got[s], want[s])
        np.testing.assert_array_equal(got[s][0][1], np.eye(4))
        assert _ate(poses, got[s]) < 0.01


def test_run_staged_equals_run(port_results):
    run, staged, chunks = port_results
    assert [c.intensity.shape[:2] for c in chunks] == [(2, 4), (2, 4)]
    assert chunks[0].live is None and chunks[1].live[:, 1:].tolist() == [[True] * 3, [False] * 3]
    for s in range(2):
        for (t1, T1, c1), (t2, T2, c2) in zip(run[s], staged[s]):
            assert t1 == t2
            np.testing.assert_array_equal(T1, T2)
            np.testing.assert_array_equal(c1, c2)


def test_init_states_matches_jax(suite):
    i0 = np.stack([items[0][1] for _, items, _ in suite])
    d0 = np.stack([items[0][2] for _, items, _ in suite])
    want = jmseq.init_states(jnp.asarray(i0), jnp.asarray(d0), jmseq.stack_cameras(_jcams(suite)), JCFG)
    cams = tmseq.stack_cameras(_tcams(suite))
    assert cams.fx.tolist() == [FX, FX2]
    got = tmseq.init_states(torch.from_numpy(i0), torch.from_numpy(d0.view(np.int16)), cams, CFG)
    for lt, lj in zip(got.kf_data, want.kf_data):
        np.testing.assert_array_equal(lt.mask.numpy(), np.asarray(lj.mask))
        np.testing.assert_allclose(lt.pcl.numpy(), np.asarray(lj.pcl), rtol=0, atol=1e-4)
        np.testing.assert_allclose(lt.templ.numpy(), np.asarray(lj.templ), rtol=0, atol=1e-4)
        np.testing.assert_allclose(lt.J.numpy(), np.asarray(lj.J), rtol=1e-2, atol=1e-2 * np.abs(lj.J).max())
    assert got.pose_last.R.shape == (2, 3, 3) and got.kf_ctr.tolist() == [0, 0]
    np.testing.assert_array_equal(got.pose_kf.t.numpy(), np.zeros((2, 3)))


def test_scan_sequences_matches_jax(suite):
    """One (S, K) = (2, 4) chunk with dead slots (the second sequence holds
    two frames), straight through `scan_sequences` of both packages."""
    i0 = np.stack([items[0][1] for _, items, _ in suite])
    d0 = np.stack([items[0][2] for _, items, _ in suite])
    inten = np.zeros((2, CHUNK, H, W), np.uint8)
    depth = np.zeros((2, CHUNK, H, W), np.uint16)
    live = np.zeros((2, CHUNK), bool)
    for s, n in enumerate((CHUNK, 2)):
        items = suite[s][1]
        inten[s, :n] = [it[1] for it in items[1 : 1 + n]]
        depth[s, :n] = [it[2] for it in items[1 : 1 + n]]
        live[s, :n] = True
    dts = np.full((2, CHUNK), DT_NS / 1e9, np.float32)

    jcams = jmseq.stack_cameras(_jcams(suite))
    jst = jmseq.init_states(jnp.asarray(i0), jnp.asarray(d0), jcams, JCFG)
    _, jposes, jvalid, jcov, jkf = jmseq.scan_sequences(jst, jnp.asarray(inten), jnp.asarray(depth),
                                                        jnp.asarray(dts), jnp.asarray(live), jcams, JCFG)
    cams = tmseq.stack_cameras(_tcams(suite))
    tst = tmseq.init_states(torch.from_numpy(i0), torch.from_numpy(d0.view(np.int16)), cams, CFG)
    _, poses, valid, cov, is_kf = tmseq.scan_sequences(
        tst, torch.from_numpy(inten), torch.from_numpy(depth.view(np.int16)), torch.from_numpy(dts),
        torch.from_numpy(live), cams, CFG)
    assert poses.R.shape == (2, CHUNK, 3, 3) and cov.shape == (2, CHUNK, 6, 6)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(is_kf.numpy(), np.asarray(jkf))
    assert valid.numpy().tolist() == live.tolist()
    for s in range(2):
        for k in range(CHUNK):
            Tt, Tj = np.eye(4), np.eye(4)
            Tt[:3, :3], Tt[:3, 3] = poses.R[s, k].numpy(), poses.t[s, k].numpy()
            Tj[:3, :3], Tj[:3, 3] = np.asarray(jposes.R[s, k]), np.asarray(jposes.t[s, k])
            assert np.linalg.norm(lie_np.log(lie_np.relative(Tt, Tj))) < 1e-3
        np.testing.assert_allclose(cov[s].numpy(), np.asarray(jcov[s]), rtol=1e-2,
                                   atol=1e-2 * np.abs(np.asarray(jcov[s])).max())
    # a dead slot re-emits the sequence's last pose
    torch.testing.assert_close(poses.t[1, 2:], poses.t[1, 1:2].expand(2, 3), rtol=0, atol=0)


def test_fold_corrections_matches_jax(suite):
    """A correction of sequence 0 right-composes onto its pose rows and
    leaves sequence 1's untouched (`tests/test_sequences.py:212`)."""
    i0 = np.stack([suite[0][1][0][1]] * 2)
    d0 = np.stack([suite[0][1][0][2]] * 2)
    delta = lie_np.exp(np.array([0.05, -0.02, 0.01, 0.02, 0.0, -0.01]))
    dR = np.stack([delta[:3, :3], np.eye(3)]).astype(np.float32)
    dt = np.stack([delta[:3, 3], np.zeros(3)]).astype(np.float32)
    jcams = jmseq.stack_cameras([JCamera.create(FX, FX, CX, CY)] * 2)
    jst = jmseq.init_states(jnp.asarray(i0), jnp.asarray(d0), jcams, JCFG)
    # start from a non-identity chain so the composition order shows
    jst = jst._replace(pose_last=jst.pose_last._replace(t=jnp.asarray([[0.1, 0.0, 0.0], [0.0, 0.2, 0.0]],
                                                                      jnp.float32)))
    want = jmseq._fold_corrections(jst, jnp.asarray(dR), jnp.asarray(dt))
    cams = tmseq.stack_cameras([Camera.create(FX, FX, CX, CY, device="cpu")] * 2)
    tst = tmseq.init_states(torch.from_numpy(i0), torch.from_numpy(d0.view(np.int16)), cams, CFG)
    tst = tst._replace(pose_last=tst.pose_last._replace(t=torch.tensor([[0.1, 0.0, 0.0], [0.0, 0.2, 0.0]])))
    got = tmseq._fold_corrections(tst, torch.from_numpy(dR), torch.from_numpy(dt))
    for pt, pj in ((got.pose_kf, want.pose_kf), (got.pose_last, want.pose_last)):
        np.testing.assert_allclose(pt.R.numpy(), np.asarray(pj.R), rtol=0, atol=1e-6)
        np.testing.assert_allclose(pt.t.numpy(), np.asarray(pj.t), rtol=0, atol=1e-6)
    T0 = np.eye(4)
    T0[:3, :3], T0[:3, 3] = got.pose_kf.R[0].numpy(), got.pose_kf.t[0].numpy()
    assert np.linalg.norm(lie_np.log(lie_np.relative(T0, delta))) < 1e-5
    np.testing.assert_allclose(got.pose_last.R[1].numpy(), np.eye(3), atol=1e-6)
    np.testing.assert_allclose(got.pose_last.t[1].numpy(), [0.0, 0.2, 0.0], atol=1e-7)


def test_identical_streams_equal_the_single_sequence_run(suite):
    _, items, _ = suite[0]
    cam = Camera.create(FX, FX, CX, CY, device="cpu")
    solo = tseq.SequentialOdometry(cam, CFG, chunk=CHUNK).run(iter(items))
    both = tmseq.MultiSequenceOdometry([cam, cam], CFG, chunk=CHUNK).run([iter(items), iter(items)])
    for res in both:
        _assert_trajectories_close(res, solo, tol=1e-6, cov=False)


def test_ragged_short_sequence_equals_its_own_run(suite, port_results):
    """The dead slots of the shorter sequence leave its trajectory what its
    own single-sequence run gives."""
    _, items, fx = suite[1]
    solo = tseq.SequentialOdometry(Camera.create(fx, fx, CX, CY, device="cpu"), CFG, chunk=CHUNK).run(iter(items))
    _assert_trajectories_close(port_results[0][1], solo, tol=1e-6, cov=False)
