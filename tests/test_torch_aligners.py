"""The port's secondary aligners against the JAX package's, on the inputs of
the JAX tests (`tests/test_fa_se3.py`, `test_icp.py`, `test_lk2d.py`).

Each pair of frames is built once by the JAX package and handed to both
(`interop.frame_from_numpy`), so the comparisons hold the aligners alone.
Tolerances (f32 on both sides, normal-equation sums in another order):

* `core.pose_cov`: compose, compose_adjoint, inverse and mean within 1e-5.
* `align_fa`, `align_icp` and their host wrappers: pose within 1e-3 (SE(3)
  log), covariance within rtol 1e-2 of its largest entry, validity equal;
  then each JAX test's own accuracy gate on the port's result.
* `OdometryIcp` with `IcpAligner` over three frames: each pose within 1e-3
  of JAX's, speed within 3e-2 (`tests/test_torch_odometry.py`'s bounds).
* `align_optical_flow`: parameters within 1e-3, validity and accepted
  iterations equal. `align_affine`: validity equal, and the two warps move
  every image corner to within 0.01 px of each other. Then the JAX tests'
  recovery gates. The port's affine solve takes its step in the
  centred parameters of its Jacobian and maps it to the warp's own before
  the update, where the JAX function applies it as if uncentred: the two
  reach the same minimum by different paths, so their iterations differ.
  At 480x640 the port recovers the JAX test's map with every image corner
  within 0.1 px (the flow gate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import affine_transform, shift as nd_shift, zoom

from vslam_tpu.alignment import lk2d as jlk2d
from vslam_tpu.alignment.aligner import RgbdAligner as JRgbdAligner
from vslam_tpu.alignment.fa_se3 import FaAlignmentConfig as JFaConfig
from vslam_tpu.alignment.fa_se3 import RgbdAlignerFa as JRgbdAlignerFa
from vslam_tpu.alignment.fa_se3 import align_fa as j_align_fa
from vslam_tpu.alignment.ic import AlignmentConfig as JAlignmentConfig
from vslam_tpu.alignment.icp import IcpAligner as JIcpAligner
from vslam_tpu.alignment.icp import IcpConfig as JIcpConfig
from vslam_tpu.alignment.icp import align_icp as j_align_icp
from vslam_tpu.core import pose_cov as jpc
from vslam_tpu.core import se3 as jse3
from vslam_tpu.core.camera import Camera as JCamera
from vslam_tpu.core.frame import create_frame as j_create_frame
from vslam_tpu.core.se3 import SE3 as JSE3
from vslam_tpu.odometry.map import HostFrame as JHostFrame
from vslam_tpu.odometry.map import Map as JMap
from vslam_tpu.odometry.odometry import OdometryIcp as JOdometryIcp
from vslam_tpu.solvers import SolverConfig as JSolverConfig
from vslam_tpu_torch import interop
from vslam_tpu_torch.alignment import aligner as taligner
from vslam_tpu_torch.alignment import fa_se3, icp, lk2d
from vslam_tpu_torch.core import lie_np
from vslam_tpu_torch.core import pose_cov as tpc
from vslam_tpu_torch.core.se3 import SE3
from vslam_tpu_torch.io import synthetic
from vslam_tpu_torch.odometry.map import HostFrame, Map
from vslam_tpu_torch.odometry.odometry import OdometryIcp
from vslam_tpu_torch.solvers import LossConfig, SolverConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

H, W, FX = 96, 128, 110.0
K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
JCAM = JCamera.create(FX, FX, (W - 1) / 2, (H - 1) / 2)
DT_NS = int(1e9 / 30)


def _port_cfg(cls, jcfg):
    """A port config with the JAX one's fields (the solver converted)."""
    import dataclasses

    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["solver"] = SolverConfig(**dataclasses.asdict(jcfg.solver))
    if "loss" in fields:
        fields["loss"] = LossConfig(**dataclasses.asdict(jcfg.loss))
    return cls(**fields)


def _frame(inten, depth):
    """(JAX frame, the port's copy of it on the CPU)."""
    jf = j_create_frame(jnp.asarray(inten), jnp.asarray(depth), JCAM, n_levels=3)
    return jf, interop.frame_from_numpy(jax.tree_util.tree_map(np.asarray, jf), device="cpu")


def _T(rel) -> np.ndarray:
    T = np.eye(4)
    u, _, vt = np.linalg.svd(np.asarray(rel.R, np.float64))
    T[:3, :3] = u @ vt
    T[:3, 3] = np.asarray(rel.t, np.float64)
    return T


def _gap(a, b) -> float:
    return float(np.linalg.norm(lie_np.log(lie_np.relative(a, b))))


def _assert_solution_close(got, want):
    (rel_t, cov_t, ok_t), (rel_j, cov_j, ok_j) = got, want
    assert bool(ok_t) == bool(ok_j)
    assert _gap(_T(rel_t), _T(rel_j)) < 1e-3
    cov_j = np.asarray(cov_j)
    np.testing.assert_allclose(cov_t.numpy(), cov_j, rtol=1e-2, atol=1e-2 * np.abs(cov_j).max())


def _identity():
    return (JSE3(jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32)),
            SE3(torch.eye(3), torch.zeros(3)))


# ---------------------------------------------------------------------------
# core.pose_cov
# ---------------------------------------------------------------------------


def test_pose_cov_matches_jax():
    rng = np.random.default_rng(0)
    xi1, xi0 = rng.normal(0, 0.3, 6), rng.normal(0, 0.3, 6)
    L = rng.normal(size=(6, 6))
    cov = (L @ L.T).astype(np.float32)
    p1j, p0j = jse3.exp(jnp.asarray(xi1, jnp.float32)), jse3.exp(jnp.asarray(xi0, jnp.float32))
    p1t, p0t = (SE3(torch.from_numpy(np.array(p.R)), torch.from_numpy(np.array(p.t))) for p in (p1j, p0j))
    pcj, pct = jpc.PoseWithCovariance(p0j, jnp.asarray(cov)), tpc.PoseWithCovariance(p0t, torch.from_numpy(cov))
    for fj, ft in ((jpc.compose, tpc.compose), (jpc.compose_adjoint, tpc.compose_adjoint)):
        gj, gt = fj(p1j, pcj), ft(p1t, pct)
        np.testing.assert_allclose(gt.pose.R.numpy(), np.asarray(gj.pose.R), atol=1e-5)
        np.testing.assert_allclose(gt.pose.t.numpy(), np.asarray(gj.pose.t), atol=1e-5)
        np.testing.assert_allclose(gt.cov.numpy(), np.asarray(gj.cov), rtol=1e-5, atol=1e-5 * np.abs(cov).max())
    np.testing.assert_allclose(pct.mean().numpy(), np.asarray(pcj.mean()), atol=1e-5)
    inv_t, inv_j = pct.inverse(), pcj.inverse()
    np.testing.assert_allclose(inv_t.pose.t.numpy(), np.asarray(inv_j.pose.t), atol=1e-5)
    np.testing.assert_array_equal(inv_t.cov.numpy(), cov)
    # the adjoint transport differs from the rotation-only one by the lever arm
    assert not np.allclose(tpc.compose(p1t, pct).cov.numpy(), tpc.compose_adjoint(p1t, pct).cov.numpy())


# ---------------------------------------------------------------------------
# Forward-additive SE(3)
# ---------------------------------------------------------------------------

FA_CFG = JFaConfig(min_gradient=10.0, solver=JSolverConfig(max_iterations=50, min_step_size=1e-7))


def _fa_pair(xi, seed):
    scene = synthetic.default_scene(seed=seed)
    f0 = _frame(*synthetic.render(K, np.eye(4), (H, W), scene))
    f1 = _frame(*synthetic.render(K, lie_np.exp(xi), (H, W), scene))
    return f0, f1


@pytest.mark.parametrize("seed", [0, 1])
def test_align_fa_matches_jax(seed):
    xi = np.array([0.02, -0.01, 0.015, 0.008, -0.006, 0.004]) * (1 + seed)
    (j0, t0), (j1, t1) = _fa_pair(xi, seed)
    rel0_j, rel0_t = _identity()
    got = fa_se3.align_fa(t0, t1, rel0_t, _port_cfg(fa_se3.FaAlignmentConfig, FA_CFG))
    _assert_solution_close(got, j_align_fa(j0, j1, rel0_j, FA_CFG))
    assert bool(got[2]) and got[1].shape == (6, 6)
    assert np.linalg.norm(lie_np.log(_T(got[0])) - xi) < 0.01


def test_fa_aligner_matches_jax_and_the_ic_baseline():
    """`RgbdAlignerFa.align` against JAX's, and against the port's
    inverse-compositional `RgbdAligner` (the dual-aligner cross-check of
    `tests/test_fa_se3.py`, within 2e-3)."""
    xi = np.array([0.015, 0.01, -0.012, -0.005, 0.007, 0.003])
    (j0, t0), (j1, t1) = _fa_pair(xi, seed=2)
    pred = np.eye(4)
    pose_t, cov_t, ok_t = fa_se3.RgbdAlignerFa(_port_cfg(fa_se3.FaAlignmentConfig, FA_CFG), device="cpu").align(
        [t0], [np.eye(4)], t1, pred)
    pose_j, cov_j, ok_j = JRgbdAlignerFa(FA_CFG).align([j0], [np.eye(4)], j1, pred)
    assert ok_t and ok_j and _gap(pose_t, pose_j) < 1e-3
    np.testing.assert_allclose(cov_t, cov_j, rtol=1e-2, atol=1e-2 * np.abs(cov_j).max())
    ic_cfg = JAlignmentConfig(min_gradient=10.0, solver=JSolverConfig(max_iterations=50, min_step_size=1e-7),
                              include_prior=False)
    import dataclasses

    pose_ic, _, ok_ic = taligner.RgbdAligner(interop.alignment_config_from_fields(dataclasses.asdict(ic_cfg))).align(
        [t0], [np.eye(4)], t1, pred)
    assert ok_ic and _gap(pose_t, pose_ic) < 2e-3
    assert _gap(pose_ic, JRgbdAligner(ic_cfg).align([j0], [np.eye(4)], j1, pred)[0]) < 1e-3


# ---------------------------------------------------------------------------
# ICP
# ---------------------------------------------------------------------------


def _render_composite(pose):
    """`tests/test_icp.py`'s three tilted planes, the nearer surface winning."""
    i, d = None, None
    for s in (synthetic.PlaneScene(normal=(0.35, 0.0, 1.0), d=2.0, seed=1),
              synthetic.PlaneScene(normal=(-0.3, 0.25, 1.0), d=1.6, seed=2),
              synthetic.PlaneScene(normal=(0.1, -0.4, 1.0), d=1.8, seed=3)):
        ii, dd = synthetic.render(K, pose, (H, W), s)
        if d is None:
            i, d = ii, dd
        else:
            take = (dd > 0) & ((dd < d) | (d <= 0))
            d = np.where(take, dd, d)
            i = np.where(take, ii, i)
    return i.astype(np.float32), d.astype(np.float32)


@pytest.fixture(scope="module")
def icp_frames():
    """The reference frame and one current frame per JAX test motion."""
    motions = {"translation": np.array([0.02, -0.01, 0.01, 0.0, 0.0, 0.0]),
               "rotation": np.array([0.0, 0.0, 0.0, 0.008, -0.01, 0.006]),
               "both": np.array([0.015, 0.01, -0.01, 0.005, 0.006, -0.004])}
    return _frame(*_render_composite(np.eye(4))), {
        k: (xi, _frame(*_render_composite(lie_np.exp(xi)))) for k, xi in motions.items()}


@pytest.mark.parametrize("variant", ["point_to_plane", "point_to_point"])
@pytest.mark.parametrize("motion", ["translation", "rotation", "both"])
def test_align_icp_matches_jax(icp_frames, variant, motion):
    (j0, t0), cur = icp_frames
    xi, (j1, t1) = cur[motion]
    jcfg = JIcpConfig(solver=JSolverConfig(max_iterations=30, min_step_size=1e-7), variant=variant)
    rel0_j, rel0_t = _identity()
    got = icp.align_icp(t0, t1, rel0_t, _port_cfg(icp.IcpConfig, jcfg))
    _assert_solution_close(got, j_align_icp(j0, j1, rel0_j, jcfg))
    budget = 0.012 if variant == "point_to_plane" else 0.03
    assert bool(got[2]) and np.linalg.norm(lie_np.log(_T(got[0])) - xi) < budget


def test_icp_normal_compatibility_gate_matches_jax(icp_frames):
    """A strict gate (cos >= 0.95) still converges as JAX does; one above 1
    excludes every correspondence and leaves the solve invalid."""
    (j0, t0), cur = icp_frames
    xi, (j1, t1) = cur["both"]
    rel0_j, rel0_t = _identity()
    for cos, valid in ((0.95, True), (1.5, False)):
        jcfg = JIcpConfig(solver=JSolverConfig(max_iterations=30, min_step_size=1e-7), min_cos_normal=cos)
        got = icp.align_icp(t0, t1, rel0_t, _port_cfg(icp.IcpConfig, jcfg))
        want = j_align_icp(j0, j1, rel0_j, jcfg)
        assert bool(got[2]) is bool(want[2]) is valid
        if valid:
            _assert_solution_close(got, want)
            assert np.linalg.norm(lie_np.log(_T(got[0])) - xi) < 0.012


def test_icp_aligner_matches_jax(icp_frames):
    (j0, t0), _ = icp_frames
    xi = np.array([0.01, 0.0, 0.005, 0.0, 0.004, 0.0])
    j1, t1 = _frame(*_render_composite(lie_np.exp(xi)))
    jcfg = JIcpConfig(solver=JSolverConfig(max_iterations=25, min_step_size=1e-7))
    pose_t, cov_t, ok_t = icp.IcpAligner(_port_cfg(icp.IcpConfig, jcfg), device="cpu").align(
        [t0], [np.eye(4)], t1, np.eye(4))
    pose_j, cov_j, ok_j = JIcpAligner(jcfg).align([j0], [np.eye(4)], j1, np.eye(4))
    assert ok_t and ok_j and _gap(pose_t, pose_j) < 1e-3 and _gap(pose_t, lie_np.exp(xi)) < 0.012
    np.testing.assert_allclose(cov_t, cov_j, rtol=1e-2, atol=1e-2 * np.abs(cov_j).max())


def test_odometry_icp_with_icp_aligner_matches_jax():
    """`OdometryIcp` tracks three frames against the last one with the
    port's `IcpAligner`, as JAX's does with its own."""
    poses = [lie_np.exp(np.array([0.008, -0.004, 0.006, 0.002, 0.003, -0.002]) * i) for i in range(3)]
    jcfg = JIcpConfig(solver=JSolverConfig(max_iterations=25, min_step_size=1e-7))
    jodo = JOdometryIcp(JIcpAligner(jcfg), JMap())
    todo = OdometryIcp(icp.IcpAligner(_port_cfg(icp.IcpConfig, jcfg), device="cpu"), Map())
    jm, tm = jodo._map, todo._map
    for i, p in enumerate(poses):
        jf, tf = _frame(*_render_composite(p))
        jh = JHostFrame(frame=jf, t_ns=i * DT_NS, pose=jodo.pose if jodo.pose is not None else np.eye(4))
        th = HostFrame(frame=tf, t_ns=i * DT_NS, pose=todo.pose if todo.pose is not None else np.eye(4))
        jodo.update(jh)
        todo.update(th)
        jh.pose, th.pose = jodo.pose, todo.pose
        jm.insert(jh)
        tm.insert(th)
        assert _gap(todo.pose, jodo.pose) < 1e-3
        np.testing.assert_allclose(todo.speed, jodo.speed, rtol=0, atol=3e-2)
    assert _gap(todo.pose, poses[2]) < 0.012


# ---------------------------------------------------------------------------
# 2-D Lucas-Kanade
# ---------------------------------------------------------------------------


def _smooth_image(seed=42, Hs=80, Ws=100):
    rng = np.random.default_rng(seed)
    return zoom(rng.uniform(0, 255, size=(Hs // 4, Ws // 4)), 4, order=3).astype(np.float32)[:Hs, :Ws]


def _affine_image(img, p):
    A = np.array([[1 + p[0], p[2], p[4]], [p[1], 1 + p[3], p[5]]])
    Ainv = np.linalg.inv(np.vstack([A, [0, 0, 1]]))
    return A, affine_transform(img, Ainv[:2, :2].T, offset=(Ainv[1, 2], Ainv[0, 2]), order=1, mode="nearest")


def _lk_pair(kind, method):
    """(port result, JAX result, truth) on `tests/test_lk2d.py`'s inputs."""
    img = _smooth_image()
    if kind == "flow":
        truth = np.array([2.3, -1.7])
        image = nd_shift(img, shift=(truth[1], truth[0]), order=1, mode="nearest")
        fj, ft = jlk2d.align_optical_flow, lk2d.align_optical_flow
    elif kind == "zero":
        truth, image = np.zeros(2), img
        fj, ft = jlk2d.align_optical_flow, lk2d.align_optical_flow
    else:
        truth, image = _affine_image(img, np.array([0.02, 0.01, -0.015, 0.025, 1.5, -2.0]))
        fj, ft = jlk2d.align_affine, lk2d.align_affine
    jcfg = jlk2d.Lk2dConfig(method=method)
    cfg = _port_cfg(lk2d.Lk2dConfig, jcfg)
    return ft(torch.from_numpy(img), torch.from_numpy(image), cfg=cfg), fj(jnp.asarray(img), jnp.asarray(image),
                                                                          cfg=jcfg), truth


@pytest.mark.parametrize("method", ["inverse_compositional", "forward_additive"])
@pytest.mark.parametrize("kind", ["flow", "affine", "zero"])
def test_lk2d_matches_jax(kind, method):
    (pt, rt), (pj, rj), truth = _lk_pair(kind, method)
    assert bool(rt.valid) == bool(rj.valid)
    assert bool(rt.valid) or kind == "zero"
    if kind == "affine":
        A_got, A_jax = (np.array([[1 + q[0], q[2], q[4]], [q[1], 1 + q[3], q[5]]], np.float64)
                        for q in (pt.numpy(), np.asarray(pj)))
        Hs, Ws = _smooth_image().shape
        corners = np.array([[0, Ws - 1, 0, Ws - 1], [0, 0, Hs - 1, Hs - 1], [1, 1, 1, 1]], np.float64)
        assert np.linalg.norm((A_got - A_jax) @ corners, axis=0).max() < 0.01
        np.testing.assert_allclose(A_got, truth, atol=0.05)
    else:
        assert int(rt.iterations) == int(rj.iterations)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-3)
        np.testing.assert_allclose(pt.numpy(), truth, atol=0.1 if kind == "flow" else 1e-3)


@pytest.mark.parametrize("method", ["inverse_compositional", "forward_additive"])
def test_lk2d_affine_recovers_the_map_at_640_wide(method):
    """The JAX test's affine map at 480x640: a step of the centred parameters
    applied as a step about the origin moves the translation by the linear
    step times the centre (320 px here), and the solve stalls two pixels
    off. The image is I = T o W^-1 with the map in (row, col) order."""
    Hs, Ws = 480, 640
    img = _smooth_image(Hs=Hs, Ws=Ws)
    A = np.array([[1.02, -0.015, 1.5], [0.01, 1.025, -2.0]])
    Ainv = np.linalg.inv(np.vstack([A, [0, 0, 1]]))
    image = affine_transform(img, Ainv[:2, :2][::-1, ::-1], offset=(Ainv[1, 2], Ainv[0, 2]), order=1,
                             mode="nearest")
    p, res = lk2d.align_affine(torch.from_numpy(img), torch.from_numpy(image), cfg=lk2d.Lk2dConfig(method=method))
    q = p.numpy().astype(np.float64)
    A_got = np.array([[1 + q[0], q[2], q[4]], [q[1], 1 + q[3], q[5]]])
    corners = np.array([[0, Ws - 1, 0, Ws - 1], [0, 0, Hs - 1, Hs - 1], [1, 1, 1, 1]], np.float64)
    assert bool(res.valid)
    np.testing.assert_allclose(A_got, A, atol=0.05)
    assert np.linalg.norm((A_got - A) @ corners, axis=0).max() < 0.1


def test_lk2d_affine_fa_ic_parity_and_batching():
    """FA and IC agree on the warp (`tests/test_lk2d.py`'s parity, 0.02), and
    a batch of two problems gives each one's own solve."""
    img = _smooth_image()
    _, image = _affine_image(img, np.array([0.01, -0.005, 0.008, 0.012, -1.0, 1.5]))
    p = {m: lk2d.align_affine(torch.from_numpy(img), torch.from_numpy(image), cfg=lk2d.Lk2dConfig(method=m))[0]
         for m in ("inverse_compositional", "forward_additive")}
    np.testing.assert_allclose(p["inverse_compositional"].numpy(), p["forward_additive"].numpy(), atol=0.02)
    flow_img = nd_shift(img, shift=(-1.7, 2.3), order=1, mode="nearest")
    both, res = lk2d.align_optical_flow(torch.from_numpy(np.stack([img, img])),
                                        torch.from_numpy(np.stack([flow_img, img])))
    assert both.shape == (2, 2) and res.valid.shape == (2,)
    one, _ = lk2d.align_optical_flow(torch.from_numpy(img), torch.from_numpy(flow_img))
    np.testing.assert_allclose(both[0].numpy(), one.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(both[1].numpy(), 0.0, atol=1e-3)
