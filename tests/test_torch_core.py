"""Parity of the PyTorch port's core numerics with the JAX package.

Inputs come from numpy seeds and go through both packages; tolerances are
f32 ones: SE(3) maps 1e-6..1e-5, intensities 1e-4, gradients 1e-3, depth
exact (the median and the decimation move values, they never compute
new ones)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.core import camera as jcam
from vslam_tpu.core import image as jimg
from vslam_tpu.core import se3 as jse3
from vslam_tpu.core.frame import create_frame as j_create_frame
from vslam_tpu.io import synthetic as jsyn
from vslam_tpu.solvers import linalg6 as jlin
from vslam_tpu_torch.alignment.aligner import stack_frames
from vslam_tpu_torch.core import camera as tcam
from vslam_tpu_torch.core import image as timg
from vslam_tpu_torch.core import lie_np as t_lie_np
from vslam_tpu_torch.core import se3 as tse3
from vslam_tpu_torch.core.frame import create_frame as t_create_frame
from vslam_tpu_torch.io import synthetic as tsyn
from vslam_tpu_torch.solvers import linalg6 as tlin
from vslam_tpu_torch.utils.tree import tree_map
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

H, W = 37, 53  # odd on purpose: reflect borders and ceil(n/2) pyramid sizes
FX = 60.0


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _random_xi(rng, n, rot_scale):
    xi = np.concatenate([rng.uniform(-0.5, 0.5, (n, 3)), rng.normal(0, rot_scale, (n, 3))], 1)
    xi[0, 3:] = 0.0  # exact identity rotation
    xi[1, 3:] = 1e-6  # deep in the small-angle branch
    return xi.astype(np.float32)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------


# 1e-5 stays in the Taylor branch; angles near 1e-3 are left out: there
# (t - sin t) / t^3 cancels catastrophically in f32 in both packages, so
# they agree only to the noise of their sin implementations
@pytest.mark.parametrize("rot_scale", [1e-5, 0.3, 1.0])
def test_se3_exp_log_match_jax(rot_scale):
    xi = _random_xi(np.random.default_rng(0), 32, rot_scale)
    gj, gt = jse3.exp(jnp.asarray(xi)), tse3.exp(_t(xi))
    np.testing.assert_allclose(gt.R.numpy(), _np(gj.R), atol=2e-6)
    np.testing.assert_allclose(gt.t.numpy(), _np(gj.t), atol=2e-6)
    np.testing.assert_allclose(tse3.log(gt).numpy(), _np(jse3.log(gj)), atol=2e-5)


def test_se3_log_near_pi_matches_jax():
    rng = np.random.default_rng(1)
    axes = rng.normal(size=(8, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    phi = axes * (np.pi - 5e-4)
    xi = np.concatenate([rng.normal(size=(8, 3)), phi], 1).astype(np.float32)
    gj, gt = jse3.exp(jnp.asarray(xi)), tse3.exp(_t(xi))
    np.testing.assert_allclose(tse3.log(gt).numpy(), _np(jse3.log(gj)), atol=2e-3)


def test_se3_compose_inverse_transform_match_jax():
    rng = np.random.default_rng(2)
    a = _random_xi(rng, 16, 0.5)
    b = _random_xi(rng, 16, 0.5)
    p = rng.normal(size=(16, 3)).astype(np.float32)
    ja, jb = jse3.exp(jnp.asarray(a)), jse3.exp(jnp.asarray(b))
    ta, tb = tse3.exp(_t(a)), tse3.exp(_t(b))
    jc, tc = jse3.compose(ja, jb), tse3.compose(ta, tb)
    np.testing.assert_allclose(tc.R.numpy(), _np(jc.R), atol=2e-6)
    np.testing.assert_allclose(tc.t.numpy(), _np(jc.t), atol=2e-6)
    ji, ti = jse3.inverse(ja), tse3.inverse(ta)
    np.testing.assert_allclose(ti.t.numpy(), _np(ji.t), atol=2e-6)
    np.testing.assert_allclose(
        tse3.transform_points(ta, _t(p)).numpy(), _np(jse3.transform_points(ja, jnp.asarray(p))),
        atol=2e-6,
    )


def test_se3_orthonormalize_matches_jax():
    rng = np.random.default_rng(3)
    R = (np.eye(3) + 0.05 * rng.normal(size=(16, 3, 3))).astype(np.float32)
    t = rng.normal(size=(16, 3)).astype(np.float32)
    gj = jse3.orthonormalize(jse3.SE3(jnp.asarray(R), jnp.asarray(t)))
    gt = tse3.orthonormalize(tse3.SE3(_t(R), _t(t)))
    np.testing.assert_allclose(gt.R.numpy(), _np(gj.R), atol=1e-6)
    np.testing.assert_allclose(gt.t.numpy(), t)


# ---------------------------------------------------------------------------
# Camera
# ---------------------------------------------------------------------------


def test_camera_project_backproject_scale_match_jax():
    rng = np.random.default_rng(4)
    p = rng.normal(size=(64, 3)).astype(np.float32)
    p[:8, 2] = -np.abs(p[:8, 2])  # behind the camera: masked, finite uv
    p[8, 2] = 0.0
    cj = jcam.Camera.create(FX, FX * 1.1, 26.0, 18.0)
    ct = tcam.Camera.create(FX, FX * 1.1, 26.0, 18.0, device="cpu")
    uvj, okj = jcam.project(cj, jnp.asarray(p))
    uvt, okt = tcam.project(ct, _t(p))
    np.testing.assert_array_equal(okt.numpy(), _np(okj))
    np.testing.assert_allclose(uvt.numpy(), _np(uvj), rtol=1e-6, atol=1e-4)
    uv = rng.uniform(0, 50, (64, 2)).astype(np.float32)
    z = rng.uniform(0.5, 3.0, 64).astype(np.float32)
    np.testing.assert_allclose(
        tcam.backproject(ct, _t(uv), _t(z)).numpy(),
        _np(jcam.backproject(cj, jnp.asarray(uv), jnp.asarray(z))), rtol=1e-6, atol=1e-6,
    )
    sj, st = jcam.scale(cj, 0.25), tcam.scale(ct, 0.25)
    np.testing.assert_allclose([float(v) for v in st], [float(v) for v in sj])


# ---------------------------------------------------------------------------
# Image ops at an odd size
# ---------------------------------------------------------------------------


def _image(seed=5):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (H, W))).astype(np.float32)


@pytest.mark.parametrize(
    "name,atol",
    [("pyr_down", 1e-4), ("gaussian_blur_3x3", 1e-4), ("sobel_x", 1e-3), ("sobel_y", 1e-3)],
)
def test_image_stencils_match_jax(name, atol):
    img = _image()
    out_j = getattr(jimg, name)(jnp.asarray(img))
    out_t = getattr(timg, name)(_t(img))
    assert tuple(out_t.shape) == out_j.shape
    np.testing.assert_allclose(out_t.numpy(), _np(out_j), atol=atol)


def test_image_stencils_map_over_leading_axes():
    imgs = np.stack([_image(6), _image(7)])
    batched = timg.pyr_down(timg.sobel_x(_t(imgs)))
    for k in range(2):
        np.testing.assert_array_equal(batched[k].numpy(), timg.pyr_down(timg.sobel_x(_t(imgs[k]))).numpy())


def test_median_blur_masked_matches_jax():
    rng = np.random.default_rng(8)
    depth = rng.uniform(0.5, 4.0, (H, W)).astype(np.float32)
    depth[rng.uniform(size=(H, W)) < 0.3] = 0.0  # holes: every valid count 0..9 occurs
    depth[10:14, 20:25] = 0.0
    out_j = jimg.median_blur_3x3_masked(jnp.asarray(depth), jnp.asarray(depth <= 0.0))
    out_t = timg.median_blur_3x3_masked(_t(depth), _t(depth <= 0.0))
    np.testing.assert_array_equal(out_t.numpy(), _np(out_j))


@pytest.mark.parametrize("name", ["bilinear_sample", "nearest_sample"])
def test_samplers_match_jax(name):
    img = _image(9)
    rng = np.random.default_rng(10)
    x = rng.uniform(-2, W + 1, 500).astype(np.float32)  # includes clamped coords
    y = rng.uniform(-2, H + 1, 500).astype(np.float32)
    x[:20] = np.round(x[:20]) + 0.5  # ties of the nearest rounding
    out_j = getattr(jimg, name)(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
    out_t = getattr(timg, name)(_t(img), _t(x), _t(y))
    np.testing.assert_allclose(out_t.numpy(), _np(out_j), atol=1e-4)


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------


def _rendered(pose, seed=7):
    K = jsyn.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    inten, depth = jsyn.render(K, pose, (H, W), jsyn.default_scene(seed))
    depth = depth.copy()
    depth[5:9, 30:40] = 0.0  # a sensor hole
    depth[20, 3] = np.nan  # a non-finite reading
    return inten, depth


def test_synthetic_render_copy_matches_jax_package():
    pose = t_lie_np.exp(np.array([0.02, -0.01, 0.03, 0.01, -0.02, 0.005]))
    K = tsyn.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    i_j, d_j = jsyn.render(K, pose, (H, W), jsyn.default_scene(3))
    i_t, d_t = tsyn.render(K, pose, (H, W), tsyn.default_scene(3))
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_array_equal(d_t, d_j)


@pytest.mark.parametrize("frame", [0, 21, 63])
def test_synthetic_render_boxes_copy_matches_jax_package(frame):
    """The robust odometry profile's scene and motion: `BoxScene(seed=4)`
    seen from poses of `orbit_trajectory(256, radius=0.4, height=0.05,
    yaw=0.12)`, bit for bit."""
    K = tsyn.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    p_t = tsyn.orbit_trajectory(256, radius=0.4, height=0.05, yaw=0.12)[frame]
    p_j = jsyn.orbit_trajectory(256, radius=0.4, height=0.05, yaw=0.12)[frame]
    np.testing.assert_array_equal(p_t, p_j)
    i_j, d_j = jsyn.render_boxes(K, p_j, (H, W), jsyn.BoxScene(seed=4))
    i_t, d_t = tsyn.render_boxes(K, p_t, (H, W), tsyn.BoxScene(seed=4))
    _, d_bg = tsyn.render(K, p_t, (H, W), tsyn.BoxScene(seed=4).background)
    assert (d_t < d_bg).any()  # a patch occludes the background
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_array_equal(d_t, d_j)


@pytest.mark.parametrize("kwargs", [{}, {"trans_amp": 0.08, "rot_amp": 0.03}])
def test_synthetic_smooth_trajectory_copy_matches_jax_package(kwargs):
    """The odometry profile's motion, bit for bit."""
    np.testing.assert_array_equal(np.stack(tsyn.smooth_trajectory(64, **kwargs)),
                                  np.stack(jsyn.smooth_trajectory(64, **kwargs)))


def test_create_frame_matches_jax():
    inten, depth = _rendered(np.eye(4))
    fj = j_create_frame(jnp.asarray(inten), jnp.asarray(depth),
                        jcam.Camera.create(FX, FX, (W - 1) / 2, (H - 1) / 2), n_levels=3)
    ft = t_create_frame(_t(inten), _t(depth),
                        tcam.Camera.create(FX, FX, (W - 1) / 2, (H - 1) / 2, device="cpu"), n_levels=3)
    for lvl in range(3):
        np.testing.assert_allclose(ft.intensity[lvl].numpy(), _np(fj.intensity[lvl]), atol=1e-4)
        np.testing.assert_array_equal(ft.depth[lvl].numpy(), _np(fj.depth[lvl]))
        np.testing.assert_allclose(ft.dIx[lvl].numpy(), _np(fj.dIx[lvl]), atol=1e-3)
        np.testing.assert_allclose(ft.dIy[lvl].numpy(), _np(fj.dIy[lvl]), atol=1e-3)
        np.testing.assert_allclose([float(c) for c in ft.cameras[lvl]],
                                   [float(c) for c in fj.cameras[lvl]])


def test_create_frame_batched_equals_per_frame():
    """A (B, H, W) batch builds the same pyramid as B single frames."""
    cam = tcam.Camera.create(FX, FX, (W - 1) / 2, (H - 1) / 2, device="cpu")
    pairs = [_rendered(np.eye(4), seed=s) for s in (1, 2)]
    singles = [t_create_frame(_t(i), _t(d), cam) for i, d in pairs]
    batched = t_create_frame(_t(np.stack([i for i, _ in pairs])), _t(np.stack([d for _, d in pairs])), cam)
    stacked = stack_frames(singles)
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), batched, stacked)


# ---------------------------------------------------------------------------
# 6x6 linear algebra
# ---------------------------------------------------------------------------


def _spd(seed, n=16):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, 6, 6)).astype(np.float32)
    A = M @ np.swapaxes(M, 1, 2) + 0.1 * np.eye(6, dtype=np.float32)
    A[0] = 0.0  # all-masked system: degenerate
    A[1, :, 5] = A[1, 5, :] = 0.0  # rank-deficient
    return A, rng.normal(size=(n, 6)).astype(np.float32)


def test_cholesky_logdet_solve_matches_jax():
    A, b = _spd(11)
    xj, lj = jlin.cholesky_logdet_solve(jnp.asarray(A), jnp.asarray(b))
    xt, lt = tlin.cholesky_logdet_solve(_t(A), _t(b))
    lj, lt = _np(lj), lt.numpy()
    np.testing.assert_array_equal(np.isfinite(lt), np.isfinite(lj))
    assert not np.isfinite(lt[:2]).any()  # degenerate systems are flagged
    ok = np.isfinite(lj)
    np.testing.assert_allclose(lt[ok], lj[ok], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(xt.numpy()[ok], _np(xj)[ok], rtol=1e-3, atol=1e-3)


def test_inv_psd_matches_jax():
    A, _ = _spd(12)
    A = A[2:]
    np.testing.assert_allclose(tlin.inv_psd(_t(A)).numpy(), _np(jlin.inv_psd(jnp.asarray(A))),
                               rtol=1e-3, atol=1e-5)
