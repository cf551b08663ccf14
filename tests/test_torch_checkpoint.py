"""The port's checkpoint / resume (`vslam_tpu_torch.utils.checkpoint`) on
the tests of `tests/test_checkpoint.py`, and its files against the JAX
package's.

The resumed trajectory is held to the uninterrupted one within 1e-4 in
SE(3) distance (the JAX test's gate) on the CPU at 96x128. A state file
holds to its own package (the port's leaves carry a sequence axis the JAX
state lacks): bf16 leaves come back bit for bit, and a leaf of another
shape or dtype, or a file the JAX package wrote, is refused with
ValueError. Landmark files are the JAX package's layout: each package
reads the other's, positions bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.odometry.map import Landmark as JLandmark
from vslam_tpu.utils import checkpoint as jcheckpoint
from vslam_tpu_torch.alignment.ic import AlignmentConfig
from vslam_tpu_torch.core import lie_np
from vslam_tpu_torch.core.camera import Camera
from vslam_tpu_torch.io import synthetic
from vslam_tpu_torch.odometry.map import Landmark
from vslam_tpu_torch.odometry.sequential import SequentialConfig, SequentialOdometry, init_state
from vslam_tpu_torch.solvers import SolverConfig
from vslam_tpu_torch.utils import checkpoint
from vslam_tpu_torch.utils.tree import tree_leaves, tree_map
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

H, W, FX = 96, 128, 110.0
CFG = SequentialConfig(
    alignment=AlignmentConfig(min_gradient=10.0, solver=SolverConfig(max_iterations=40, min_step_size=1e-7),
                              include_prior=True),
    n_levels=2,
    kf_period=3,
)


def _camera():
    return Camera.create(FX, FX, (W - 1) / 2, (H - 1) / 2, device="cpu")


def _stream(n, seed=3, shape=(H, W)):
    K = synthetic.camera_matrix(FX, FX, (shape[1] - 1) / 2, (shape[0] - 1) / 2)
    poses = synthetic.smooth_trajectory(n, trans_amp=0.06, rot_amp=0.02, seed=seed)
    p0i = lie_np.inv(poses[0])
    dt = int(1e9 / 30)
    return [(i * dt, *synthetic.render(K, p @ p0i, shape)) for i, p in enumerate(poses)]


def test_sequential_checkpoint_resume(tmp_path):
    """Stop after the first 8 of 12 frames, checkpoint, resume in a new
    SequentialOdometry from a fresh init_state: the trajectory equals the
    uninterrupted run's."""
    cam = _camera()
    stream = _stream(12)
    full = SequentialOdometry(cam, CFG, chunk=4).run(iter(stream))

    odo1 = SequentialOdometry(cam, CFG, chunk=4)
    first = odo1.run(iter(stream[:8]))
    ckpt = str(tmp_path / "state.npz")
    checkpoint.save_sequential(ckpt, odo1.state, odo1._t_last_ns)

    odo2 = SequentialOdometry(cam, CFG, chunk=4)
    _, i0, d0 = stream[0]
    odo2.state, odo2._t_last_ns = checkpoint.load_sequential(ckpt, init_state(i0, d0, cam, CFG))
    resumed = first + odo2.run(iter(stream[8:]))

    assert len(resumed) == len(full) == 12
    for (t_a, T_a, _), (t_b, T_b, _) in zip(resumed, full):
        assert t_a == t_b
        assert np.linalg.norm(lie_np.log(lie_np.relative(T_a, T_b))) < 1e-4


def _state(cfg=CFG, shape=(H, W)):
    _, i0, d0 = _stream(1, shape=shape)[0]
    return init_state(i0, d0, Camera.create(FX, FX, (shape[1] - 1) / 2, (shape[0] - 1) / 2, device="cpu"), cfg)


def test_bf16_leaves_round_trip_bit_for_bit(tmp_path):
    """numpy has no bfloat16: such leaves travel as their 16-bit pattern
    and come back bit for bit, with every other leaf's dtype kept."""
    state = _state()
    state = state._replace(kf_data=tree_map(lambda x: x.to(torch.bfloat16) if x.is_floating_point() else x,
                                            state.kf_data))
    path = str(tmp_path / "bf16.npz")
    checkpoint.save_sequential(path, state, 123)
    back, t_last = checkpoint.load_sequential(path, state)
    assert t_last == 123
    got, want = tree_leaves(back), tree_leaves(state)
    assert sum(x.dtype == torch.bfloat16 for x in got) == 8  # pcl, J, templ, n_constraints x 2 levels
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and a.device == b.device
        if a.dtype == torch.bfloat16:
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))
        else:
            assert torch.equal(a, b)


@pytest.mark.parametrize("what", ["shape", "dtype"])
def test_a_leaf_that_differs_is_refused(tmp_path, what):
    path = str(tmp_path / "state.npz")
    checkpoint.save_sequential(path, _state(), 0)
    if what == "shape":
        like = _state(shape=(H // 2, W // 2))
    else:
        like = _state()
        like = like._replace(speed=like.speed.double())
    with pytest.raises(ValueError, match="checkpoint leaf"):
        checkpoint.load_sequential(path, like)


def test_a_jax_state_file_is_refused(tmp_path):
    """The port does not read the JAX package's state files: their leaves
    lack the sequence axis, and the file lacks the dtype record."""
    path = str(tmp_path / "jax_state.npz")
    jcheckpoint.save_sequential(path, (jnp.zeros(3), jnp.ones((2, 2))), 7)
    with pytest.raises(ValueError, match="save_sequential"):
        checkpoint.load_sequential(path, (torch.zeros(3), torch.ones(2, 2)))


def test_landmark_roundtrip(tmp_path):
    lms = [Landmark(position=np.array([1.0, 2.0, 3.0]), observations={5: 2, 9: 7}),
           Landmark(position=np.array([-0.5, 0.1, 4.2]), observations={})]
    path = str(tmp_path / "landmarks.npz")
    checkpoint.save_landmarks(path, lms)
    back = checkpoint.load_landmarks(path)
    assert len(back) == 2
    np.testing.assert_allclose(back[0].position, lms[0].position)
    assert back[0].observations == {5: 2, 9: 7}
    assert back[0].id == lms[0].id
    assert back[1].observations == {}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_landmark_files_cross_packages(tmp_path, writer):
    """A landmark file written by one package is read by the other: the
    same ids, observations and positions, bit for bit; an empty map too."""
    rng = np.random.default_rng(11)
    specs = [(rng.normal(size=3), {int(k): int(rng.integers(0, 500)) for k in rng.integers(0, 90, 3)}, 1000 + i)
             for i in range(25)]
    save, load = ((jcheckpoint.save_landmarks, checkpoint.load_landmarks) if writer == "jax"
                  else (checkpoint.save_landmarks, jcheckpoint.load_landmarks))
    make = JLandmark if writer == "jax" else Landmark
    path = str(tmp_path / "landmarks.npz")
    save(path, [make(position=p, observations=o, id=i) for p, o, i in specs])
    back = load(path)
    assert [(lm.id, lm.observations) for lm in back] == [(i, o) for _, o, i in specs]
    np.testing.assert_array_equal(np.stack([lm.position for lm in back]), np.stack([p for p, _, _ in specs]))
    save(path, [])
    assert load(path) == []


def test_landmarks_of_a_mapping_run_round_trip(tmp_path):
    """The landmarks a mapping run leaves (CPU, 96x128) survive the round
    trip: same count, ids and positions."""
    from vslam_tpu_torch.odometry.sequential_mapping import ChunkMappingBackend

    backend = ChunkMappingBackend(enable_ba=True, device="cpu")
    cfg = dataclasses.replace(CFG, n_levels=3, kf_period=5)
    SequentialOdometry(_camera(), cfg, chunk=4, mapping=backend).run(iter(_stream(10)))
    lms = backend.map.points()
    assert len(lms) > 0
    path = str(tmp_path / "map.npz")
    checkpoint.save_landmarks(path, lms)
    back = checkpoint.load_landmarks(path)
    assert [lm.id for lm in back] == [lm.id for lm in lms]
    np.testing.assert_array_equal(np.stack([lm.position for lm in back]), np.stack([lm.position for lm in lms]))
