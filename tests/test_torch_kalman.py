"""Parity of the port's Kalman filters and `tracking_step` with the JAX
package.

The filters run on numpy-seeded states (pose, velocity, a random SPD
covariance); the port's functions take a leading batch axis, so a batch of
three filters is held against three JAX calls. `tracking_step` runs B = 2
pairs through EKF predict, the robust (Huber) whole-level GN solve (the
JAX Pallas kernel in interpret mode; the port's plain version on the CPU)
and the velocity update. Tolerances: filter algebra rtol 1e-5 / atol 1e-6
(f32, other summation order); tracking poses 1e-3 and velocities 1e-2
(they divide the pose by dt = 1/30 s).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.alignment import AlignmentConfig as JAlignmentConfig
from vslam_tpu.core import lie_np
from vslam_tpu.core.camera import Camera as JCamera
from vslam_tpu.core.frame import create_frame as j_create_frame
from vslam_tpu.core.se3 import SE3 as JSE3
from vslam_tpu.io import synthetic
from vslam_tpu.kalman import ekf_se3 as jekf
from vslam_tpu.kalman import filter as jfilter
from vslam_tpu.parallel.batched import tracking_step as j_tracking_step
from vslam_tpu.solvers import LossConfig as JLossConfig
from vslam_tpu.solvers import SolverConfig as JSolverConfig
from vslam_tpu_torch import interop
from vslam_tpu_torch.core import se3 as tse3
from vslam_tpu_torch.kalman import ekf_se3 as tekf
from vslam_tpu_torch.kalman import filter as tfilter
from vslam_tpu_torch.parallel.batched import tracking_step as t_tracking_step

TOL = dict(rtol=1e-5, atol=1e-6)


def _spd(rng, n, scale=1.0):
    A = rng.normal(0, 1, (n, n))
    return (A @ A.T / n + 0.1 * np.eye(n)) * scale


def _ekf_states(seed, count=3):
    """JAX EKF states with random pose, velocity and covariance."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        T = lie_np.exp(np.concatenate([rng.uniform(-0.5, 0.5, 3), rng.uniform(-0.3, 0.3, 3)]))
        out.append(jekf.EkfState(
            pose=JSE3(jnp.asarray(T[:3, :3], jnp.float32), jnp.asarray(T[:3, 3], jnp.float32)),
            velocity=jnp.asarray(rng.normal(0, 0.5, 6), jnp.float32),
            P=jnp.asarray(_spd(rng, 12, 0.1), jnp.float32),
            Q=jnp.asarray(np.eye(12) * 1e-2, jnp.float32),
        ))
    return out


def _batch(states):
    """Stack JAX states into the port's batched EkfState."""
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *states)
    return interop.ekf_state_from_numpy(stacked)


def _assert_ekf_close(port, jax_states, **tol):
    for i, js in enumerate(jax_states):
        np.testing.assert_allclose(port.pose.R[i].numpy(), np.asarray(js.pose.R), **tol)
        np.testing.assert_allclose(port.pose.t[i].numpy(), np.asarray(js.pose.t), **tol)
        np.testing.assert_allclose(port.velocity[i].numpy(), np.asarray(js.velocity), **tol)
        np.testing.assert_allclose(port.P[i].numpy(), np.asarray(js.P), **tol)


def test_ekf_init_matches_jax():
    T = lie_np.exp(np.array([0.1, -0.2, 0.3, 0.05, 0.02, -0.1]))
    pose = JSE3(jnp.asarray(T[:3, :3], jnp.float32), jnp.asarray(T[:3, 3], jnp.float32))
    j = jekf.init(pose, process_noise=3e-3)
    t = tekf.init(interop.se3_from_numpy(pose), process_noise=3e-3)
    for a, b in zip(jax.tree_util.tree_leaves(j), (t.pose.R, t.pose.t, t.velocity, t.P, t.Q)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=0)


@pytest.mark.parametrize("dt", [1.0 / 30.0, 0.0, -0.01])
def test_ekf_predict_matches_jax(dt):
    states = _ekf_states(0)
    port, pose = tekf.predict(_batch(states), torch.full((3,), dt))
    outs = [jekf.predict(s, dt) for s in states]
    _assert_ekf_close(port, [o[0] for o in outs], **TOL)
    for i, (_, jpose) in enumerate(outs):
        np.testing.assert_allclose(pose.t[i].numpy(), np.asarray(jpose.t), **TOL)


def test_ekf_process_jacobian_matches_jax():
    rng = np.random.default_rng(1)
    v_dt = rng.normal(0, 0.05, 6).astype(np.float32)
    want = jekf._process_jacobian(jnp.asarray(v_dt), jnp.float32(0.04), jnp.float32)
    got = tekf._process_jacobian(torch.as_tensor(v_dt), torch.tensor(0.04))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ekf_update_matches_jax():
    states = _ekf_states(2)
    rng = np.random.default_rng(3)
    v = rng.normal(0, 0.5, (3, 6)).astype(np.float32)
    R = np.stack([_spd(rng, 6, 1e-2) for _ in range(3)]).astype(np.float32)
    port = tekf.update(_batch(states), torch.as_tensor(v), torch.as_tensor(R))
    _assert_ekf_close(port, [jekf.update(s, jnp.asarray(v[i]), jnp.asarray(R[i]))
                             for i, s in enumerate(states)], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["spd", "zero", "nan"])
def test_measurement_noise_from_cov_matches_jax(kind):
    rng = np.random.default_rng(4)
    cov = _spd(rng, 6, 1e-4).astype(np.float32)
    if kind == "zero":
        cov[:] = 0.0
    elif kind == "nan":
        cov[2, 3] = np.nan
    got = tekf.measurement_noise_from_cov(torch.as_tensor(cov)[None], scale=2e-2)[0]
    want = jekf.measurement_noise_from_cov(jnp.asarray(cov), scale=2e-2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_linear_kalman_filter_matches_jax():
    rng = np.random.default_rng(5)
    n, m = 4, 2
    x = rng.normal(0, 1, (2, n)).astype(np.float32)
    P = np.stack([_spd(rng, n) for _ in range(2)]).astype(np.float32)
    A = rng.normal(0, 0.5, (n, n)).astype(np.float32) + np.eye(n, dtype=np.float32)
    Q = (np.eye(n) * 1e-2).astype(np.float32)
    H = rng.normal(0, 1, (m, n)).astype(np.float32)
    R = (np.eye(m) * 0.1).astype(np.float32)
    z = rng.normal(0, 1, (2, m)).astype(np.float32)
    T = torch.as_tensor
    pred = tfilter.predict(tfilter.KalmanState(T(x), T(P)), T(A), T(Q))
    upd, innov = tfilter.update(pred, T(z), T(H), T(R))
    for i in range(2):
        jp = jfilter.predict(jfilter.KalmanState(jnp.asarray(x[i]), jnp.asarray(P[i])), A, Q)
        ju, jy = jfilter.update(jp, jnp.asarray(z[i]), H, R)
        np.testing.assert_allclose(pred.P[i].numpy(), np.asarray(jp.P), **TOL)
        np.testing.assert_allclose(upd.x[i].numpy(), np.asarray(ju.x), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(upd.P[i].numpy(), np.asarray(ju.P), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(innov[i].numpy(), np.asarray(jy), **TOL)


def test_tracking_step_matches_jax():
    """B = 2 pairs, moving filters, the robust fused_gn profile."""
    H, W = 60, 80
    fx = 525.0 * W / 640
    K = synthetic.camera_matrix(fx, fx, (W - 1) / 2, (H - 1) / 2)
    cam = JCamera.create(fx, fx, (W - 1) / 2, (H - 1) / 2)
    dt = 1.0 / 30.0
    rng = np.random.default_rng(6)
    refs, curs, vels = [], [], []
    for b in range(2):
        xi = np.concatenate([rng.uniform(-0.01, 0.01, 3), rng.uniform(-0.005, 0.005, 3)])
        vels.append(0.8 * xi / dt)  # the filter's velocity: near the true motion
        scene = synthetic.default_scene(seed=b)
        for lst, pose in ((refs, np.eye(4)), (curs, lie_np.exp(xi))):
            inten, depth = synthetic.render(K, pose, (H, W), scene)
            lst.append(j_create_frame(jnp.asarray(inten), jnp.asarray(depth), cam, n_levels=2))
    stack = lambda fs: jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *fs)  # noqa: E731
    ref, cur = stack(refs), stack(curs)
    ekf0 = jax.vmap(lambda v: jekf.init()._replace(velocity=v))(jnp.asarray(np.stack(vels), jnp.float32))
    cfg = JAlignmentConfig(
        min_gradient=10.0, loss=JLossConfig("Huber"),
        solver=JSolverConfig(max_iterations=20, min_step_size=1e-11, min_relative_reduction=1e-4),
        prior_weight=(fx / 525.0) ** 2, interpolation="nearest", sampler="fused_gn",
        max_points=512,
    )
    dts = jnp.full((2,), dt, jnp.float32)
    j_ekf, j_rel, j_valid = jax.tree_util.tree_map(np.asarray, j_tracking_step(ekf0, ref, cur, dts, cfg))

    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    t_ekf, t_rel, t_valid = t_tracking_step(
        interop.ekf_state_from_numpy(to_np(ekf0)), interop.frame_from_numpy(to_np(ref)),
        interop.frame_from_numpy(to_np(cur)), torch.full((2,), dt),
        interop.alignment_config_from_fields(dataclasses.asdict(cfg)),
    )
    assert t_valid.tolist() == j_valid.tolist() == [True, True]
    np.testing.assert_allclose(t_rel.R.numpy(), j_rel.R, atol=1e-3)
    np.testing.assert_allclose(t_rel.t.numpy(), j_rel.t, atol=1e-3)
    d = tse3.log(tse3.compose(tse3.inverse(interop.se3_from_numpy(j_rel)), t_rel)).norm(dim=-1)
    assert float(d.max()) < 1e-3
    np.testing.assert_allclose(t_ekf.velocity.numpy(), j_ekf.velocity, atol=1e-2)
    np.testing.assert_allclose(t_ekf.P.numpy(), j_ekf.P, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(t_ekf.pose.t.numpy(), j_ekf.pose.t, atol=1e-3)
