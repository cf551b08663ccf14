"""The rest of the JAX package's public API in the port, on the cases of
`tests/test_{image,se3,camera,solvers,observability}.py`, against the JAX
functions on the same seeded inputs.

Tolerances: f32, within 1e-5 relative where both run the same operations
in the same order (the separable stencils, SE(3), the camera, the unrolled
Cholesky, the resize). The JAX `conv2d_*` run `lax.conv`, the port one
multiply-add a tap: their sums differ in order, so they are held within
1e-5 of the response's largest magnitude. `grad_x/y` truncate toward zero,
so they are compared on integer images (8-bit intensities, the reference's
input), where every partial sum is exact and the results equal. LM is held
to the JAX function's accepted-step count, stop iteration and trial chi2
history (within 1e-4 relative, or 1e-9 absolute once chi2 reaches f32's
floor), and its x within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.core import camera as jcam
from vslam_tpu.core import image as jimage
from vslam_tpu.core import se3 as jse3
from vslam_tpu.solvers import SolverConfig as JSolverConfig
from vslam_tpu.solvers import linalg6 as jlinalg6
from vslam_tpu.solvers import normal_equations as jne
from vslam_tpu.solvers import solve_levenberg_marquardt as jlm
from vslam_tpu_torch.core import camera as tcam
from vslam_tpu_torch.core import image as timage
from vslam_tpu_torch.core import se3 as tse3
from vslam_tpu_torch.solvers import SolverConfig, linalg6, solve_levenberg_marquardt
from vslam_tpu_torch.solvers import normal_equations as tne
from vslam_tpu_torch.utils import log as tlog
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

RTOL = 1e-5
H, W = 30, 41


def _np(x):
    return np.asarray(x)


def _img(seed=0, integer=False, shape=(H, W)):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, shape)
    return (np.round(img) if integer else img).astype(np.float32)


def _close_to_scale(a, b, tol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1e-30))


# --- core/image ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["scharr_x", "scharr_y"])
def test_scharr_matches_jax(name):
    img = _img(1)
    got = getattr(timage, name)(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), _np(getattr(jimage, name)(jnp.asarray(img))), rtol=RTOL, atol=1e-3)
    batched = getattr(timage, name)(torch.from_numpy(np.stack([img, img[::-1].copy()])))
    np.testing.assert_array_equal(batched[0].numpy(), got.numpy())


@pytest.mark.parametrize("name", ["grad_x", "grad_y"])
def test_grad_matches_jax_on_integer_images(name):
    """Reference gradX/gradY: Scharr / 32, border zero, truncated."""
    imgs = np.stack([_img(2, integer=True), _img(3, integer=True)])
    got = getattr(timage, name)(torch.from_numpy(imgs)).numpy()
    for i in range(2):
        np.testing.assert_array_equal(got[i], _np(getattr(jimage, name)(jnp.asarray(imgs[i]))))
    assert np.all(got[:, 0] == 0) and np.all(got[:, :, -1] == 0)
    assert np.all(got == np.trunc(got)) and np.abs(got).max() > 10


@pytest.mark.parametrize("kernel", [np.array([[1.0, 2, -1], [0, 3, 1], [-2, 1, 4]]),
                                    np.arange(15.0).reshape(5, 3) - 7.0], ids=["3x3", "5x3"])
def test_conv2d_matches_jax(kernel):
    img = _img(4)
    k32 = kernel.astype(np.float32)
    _close_to_scale(timage.conv2d_reflect(torch.from_numpy(img), torch.from_numpy(k32)).numpy(),
                    jimage.conv2d_reflect(jnp.asarray(img), jnp.asarray(k32)))
    got = timage.conv2d_norm_interior(torch.from_numpy(img), torch.from_numpy(k32)).numpy()
    _close_to_scale(got, jimage.conv2d_norm_interior(jnp.asarray(img), jnp.asarray(k32)))
    ky, kx = kernel.shape[0] // 2, kernel.shape[1] // 2
    assert np.all(got[:ky] == 0) and np.all(got[:, :kx] == 0) and np.all(got[:, W - kx:] == 0)


@pytest.mark.parametrize("s", [1.0, 0.5, 0.25, 0.75, 0.6])
def test_resize_bilinear_matches_jax(s):
    img = _img(5, shape=(48, 64))
    got = timage.resize_bilinear(torch.from_numpy(img), s).numpy()
    want = _np(jimage.resize_bilinear(jnp.asarray(img), s))
    assert got.shape == want.shape == (int(48 * s), int(64 * s))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-3)
    batched = timage.resize_bilinear(torch.from_numpy(np.stack([img, img])), s).numpy()
    np.testing.assert_array_equal(batched[1], got)


# --- core/se3 -----------------------------------------------------------------


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    xi = rng.normal(scale=0.4, size=(n, 6)).astype(np.float32)
    return tse3.exp(torch.from_numpy(xi)), jse3.exp(jnp.asarray(xi))


def test_matrix_round_trip_matches_jax():
    tg, _ = _poses(5, 0)
    T = tse3.to_matrix(tg)
    np.testing.assert_array_equal(T.numpy(), _np(jse3.to_matrix(jse3.SE3(jnp.asarray(tg.R.numpy()),
                                                                          jnp.asarray(tg.t.numpy())))))
    back = tse3.from_matrix(T)
    np.testing.assert_array_equal(back.R.numpy(), tg.R.numpy())
    np.testing.assert_array_equal(back.t.numpy(), tg.t.numpy())


def test_so3_exp_and_vee_match_jax():
    rng = np.random.default_rng(1)
    w = rng.normal(scale=0.7, size=(20, 3)).astype(np.float32)
    w[:4] *= 1e-5  # the Taylor branch
    R = tse3.so3_exp(torch.from_numpy(w))
    np.testing.assert_allclose(R.numpy(), _np(jse3.so3_exp(jnp.asarray(w))), rtol=RTOL, atol=1e-6)
    W_ = tse3.so3_hat(torch.from_numpy(w))
    np.testing.assert_array_equal(tse3.so3_vee(W_).numpy(), w)
    np.testing.assert_array_equal(tse3.so3_vee(W_).numpy(), _np(jse3.so3_vee(jnp.asarray(W_.numpy()))))


def test_relative_matches_jax():
    (ta, ja), (tb, jb) = _poses(4, 2), _poses(4, 3)
    rel_t, rel_j = tse3.relative(ta, tb), jse3.relative(ja, jb)
    np.testing.assert_allclose(rel_t.R.numpy(), _np(rel_j.R), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(rel_t.t.numpy(), _np(rel_j.t), rtol=RTOL, atol=1e-6)
    # T_cur_ref . ref == cur
    back = tse3.compose(rel_t, ta)
    np.testing.assert_allclose(back.t.numpy(), tb.t.numpy(), atol=1e-5)


# --- core/camera --------------------------------------------------------------


def test_ray_and_intrinsic_matrix_match_jax():
    jc = jcam.Camera.create(525.0, 520.0, 319.5, 239.5)
    tc = tcam.Camera.create(525.0, 520.0, 319.5, 239.5, device="cpu")
    uv = np.random.default_rng(6).uniform(0, 640, (7, 2)).astype(np.float32)
    np.testing.assert_allclose(tcam.ray(tc, torch.from_numpy(uv)).numpy(), _np(jcam.ray(jc, jnp.asarray(uv))),
                               rtol=RTOL)
    np.testing.assert_allclose(tcam.ray(tc, torch.tensor([319.5, 239.5])).numpy(), [0.0, 0.0, 1.0])
    np.testing.assert_array_equal(tcam.intrinsic_matrix(tc).numpy(), _np(jcam.intrinsic_matrix(jc)))
    batch = tcam.Camera(*(torch.tensor([v, 2 * v]) for v in (525.0, 520.0, 319.5, 239.5)))
    K = tcam.intrinsic_matrix(batch).numpy()
    assert K.shape == (2, 3, 3)
    np.testing.assert_array_equal(K[0], _np(jcam.intrinsic_matrix(jc)))


# --- solvers ------------------------------------------------------------------


def test_normal_equations_build_combine_scale_match_jax():
    rng = np.random.default_rng(7)
    J = rng.normal(size=(50, 6)).astype(np.float32)
    r = rng.normal(size=50).astype(np.float32)
    w = rng.uniform(0, 1, 50).astype(np.float32)
    w[:5] = 0.0
    t_ne = tne.build(torch.from_numpy(J), torch.from_numpy(r), torch.from_numpy(w))
    j_ne = jne.build(jnp.asarray(J), jnp.asarray(r), jnp.asarray(w))
    for a, b in zip(t_ne, j_ne):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=RTOL, atol=1e-5)
    batched = tne.build(torch.from_numpy(np.stack([J, 2 * J])), torch.from_numpy(np.stack([r, r])),
                        torch.from_numpy(np.stack([w, w])), n=torch.tensor([3.0, 4.0]))
    np.testing.assert_allclose(batched.A[0].numpy(), t_ne.A.numpy(), rtol=RTOL)
    np.testing.assert_array_equal(batched.n.numpy(), [3.0, 4.0])
    # the JAX test's combine case
    Jc, rc, wc = np.eye(2, dtype=np.float32), np.array([1.0, 2.0], np.float32), np.ones(2, np.float32)
    tot = tne.combine([tne.build(*map(torch.from_numpy, (Jc, rc, wc))),
                       tne.build(*map(torch.from_numpy, (Jc, 2 * rc, wc)))])
    jtot = jne.combine([jne.build(*map(jnp.asarray, (Jc, rc, wc))), jne.build(*map(jnp.asarray, (Jc, 2 * rc, wc)))])
    for a, b in zip(tot, jtot):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    np.testing.assert_allclose(tot.A.numpy(), 2 * np.eye(2))
    assert float(tot.n) == 4.0
    sc, jsc = tne.scale(t_ne, 0.25), jne.scale(j_ne, 0.25)
    for a, b in zip(sc, jsc):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=RTOL, atol=1e-5)


def test_cholesky_det_solve_matches_jax():
    rng = np.random.default_rng(8)
    M = rng.normal(size=(6, 8, 6)).astype(np.float32)
    A = M.transpose(0, 2, 1) @ M + 0.1 * np.eye(6, dtype=np.float32)
    A[5] = A[4]
    A[5, :, 5] = A[5, :, 4]
    A[5, 5, :] = A[5, 4, :]  # a duplicated direction: degenerate, det 0
    b = rng.normal(size=(6, 6)).astype(np.float32)
    x, det = linalg6.cholesky_det_solve(torch.from_numpy(A), torch.from_numpy(b))
    jx, jdet = jlinalg6.cholesky_det_solve(jnp.asarray(A), jnp.asarray(b))
    np.testing.assert_allclose(x[:5].numpy(), _np(jx)[:5], rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(det.numpy(), _np(jdet), rtol=1e-4)
    assert float(det[5]) == float(jdet[5]) == 0.0
    np.testing.assert_allclose(det[:5].numpy(), np.linalg.det(A[:5].astype(np.float64)), rtol=1e-3)


def _decay_problem(t_backend):
    """The JAX test's exponential-decay fit y = exp(-k x), k = 1.3."""
    if t_backend:
        x = torch.linspace(0, 3, 40)
        y = torch.exp(-1.3 * x)

        def compute_ne(p):  # p: (B, 1)
            pred = torch.exp(-p * x)
            return tne.build((-x * pred)[..., None], y - pred, torch.ones_like(pred))

        return compute_ne
    x = jnp.linspace(0, 3, 40)
    y = jnp.exp(-1.3 * x)

    def compute_ne(p):
        pred = jnp.exp(-p[0] * x)
        return jne.build((-x * pred)[:, None], y - pred, jnp.ones_like(pred))

    return compute_ne


@pytest.mark.parametrize("k0", [0.2, 3.0, 1.29])
def test_levenberg_marquardt_matches_jax(k0):
    cfg, jcfg = SolverConfig(max_iterations=50, min_step_size=1e-10), JSolverConfig(max_iterations=50,
                                                                                    min_step_size=1e-10)
    res = solve_levenberg_marquardt(_decay_problem(True), lambda p, dx: p + dx, torch.tensor([[k0]]), 1, cfg)
    jres = jlm(_decay_problem(False), lambda p, dx: p + dx, jnp.asarray([k0], jnp.float32), 1, jcfg)
    assert bool(res.valid[0]) and bool(jres.valid)
    assert int(res.iterations[0]) == int(jres.iterations)
    h, jh = res.chi2_history[0].numpy(), _np(jres.chi2_history)
    np.testing.assert_array_equal(np.isfinite(h), np.isfinite(jh))  # the same stop iteration
    np.testing.assert_allclose(h[np.isfinite(h)], jh[np.isfinite(jh)], rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(res.x[0].numpy(), _np(jres.x), rtol=RTOL)
    assert float(res.x[0, 0]) == pytest.approx(1.3, abs=1e-3)
    np.testing.assert_allclose(res.chi2[0].numpy(), _np(jres.chi2), rtol=1e-3, atol=1e-9)


def test_levenberg_marquardt_batch_equals_single_problems():
    """Each problem of a batch stops at its own iteration with the result
    it has alone."""
    cfg = SolverConfig(max_iterations=50, min_step_size=1e-10)
    k0 = torch.tensor([[0.2], [3.0], [1.29]])
    batch = solve_levenberg_marquardt(_decay_problem(True), lambda p, dx: p + dx, k0, 1, cfg)
    for i in range(3):
        one = solve_levenberg_marquardt(_decay_problem(True), lambda p, dx: p + dx, k0[i:i + 1], 1, cfg)
        assert int(batch.iterations[i]) == int(one.iterations[0])
        np.testing.assert_array_equal(batch.x[i].numpy(), one.x[0].numpy())
        np.testing.assert_array_equal(batch.chi2_history[i].numpy(), one.chi2_history[0].numpy())


def test_levenberg_marquardt_insufficient_constraints():
    """Fewer constraints than parameters: no step is taken (JAX alike)."""
    def t_ne(p):
        return tne.build(torch.ones(p.shape[0], 1, 2), torch.ones(p.shape[0], 1), torch.ones(p.shape[0], 1))

    def j_ne(p):
        return jne.build(jnp.ones((1, 2)), jnp.ones(1), jnp.ones(1))

    res = solve_levenberg_marquardt(t_ne, lambda p, dx: p + dx, torch.zeros(1, 2), 2)
    jres = jlm(j_ne, lambda p, dx: p + dx, jnp.zeros(2), 2)
    assert not bool(res.valid[0]) and not bool(jres.valid)
    assert int(res.iterations[0]) == int(jres.iterations) == 0
    assert int(np.isfinite(res.chi2_history[0].numpy()).sum()) == int(np.isfinite(_np(jres.chi2_history)).sum())
    np.testing.assert_array_equal(res.x.numpy(), 0.0)


# --- utils/log ----------------------------------------------------------------


def test_registered_logs_list_the_sinks():
    tlog.log_img("TorchApiSinkB")
    tlog.log_img("TorchApiSinkA")
    tlog.log_plt("TorchApiPlot")
    names = tlog.registered_image_logs()
    assert {"TorchApiSinkA", "TorchApiSinkB"} <= set(names) and names == sorted(names)
    assert "TorchApiPlot" in tlog.registered_plot_logs()
    assert "TorchApiPlot" not in names
