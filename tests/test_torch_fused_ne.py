"""Parity of the port's per-iteration residual kernels with the JAX package.

The plain versions of `fused_ne.fused_level_sample` and
`fused_ne.fused_level_ne` (what the wrappers run on CPU tensors, and what
the CUDA kernels are held to bit for bit on the card) against the JAX
`fused_level_sample` and `fused_level_ne` Pallas kernels in interpret mode
(through `pack_level`, sliced back to the P points), on one 96x128 level at
a non-identity pose: F = 1 and F = 2 stacked frames, nearest and bilinear,
f32 and bf16 image.

Tolerances: visibility equal everywhere; iwxp within 1e-3 (the one-hot
matmul and the direct read round the same two or four products); A within
rtol 2e-4 / atol 1e-3, b within rtol 2e-4 / atol 1e-2 and chi2 within
rtol 1e-3 (the `test_alignment.py::test_fused_ne_matches_gather_ne` limits;
the sums run in another order); n_visible equal.

Bilinear sampling of a bf16 image rounds the row weights to bf16, and the
two packages compute the warped row v to within one f32 ulp of each other
(XLA contracts multiply-adds). Where that ulp moves a row weight across a
bf16 rounding tie, the weight moves by one bf16 step and the sample by up
to 2^-8 x 128 = 0.5; where a weight rounds to 1.0 the ulp moves the sample
by up to ~2e-3. So in bf16 bilinear mode: at least 99.5 % of the visible
samples within 2e-3, all within 0.5, and b within 1e-3 of max|b| (a few
such samples times their Jacobian rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.alignment import fused_ne as jfused_ne
from vslam_tpu.alignment import ic as jic
from vslam_tpu.core import lie_np
from vslam_tpu.core.camera import Camera as JCamera
from vslam_tpu.core.frame import create_frame as j_create_frame
from vslam_tpu.core.se3 import SE3 as JSE3
from vslam_tpu.io import synthetic
from vslam_tpu_torch import interop
from vslam_tpu_torch.alignment import fused_ne
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

H, W = 96, 128
FX = 525.0 * W / 640
XI_CUR = np.array([0.01, -0.006, 0.008, 0.003, -0.004, 0.002])
XI_MID = 0.5 * XI_CUR
# the pose each stacked frame is evaluated at: off the truth, as inside a solve
XI_OFF = np.array([0.002, 0.001, -0.003, 0.001, 0.0, 0.002])


@pytest.fixture(scope="module")
def level():
    """Level-0 data of the reference frame and a half-way frame (JAX), the
    current image and camera, and the per-frame poses (F = 2)."""
    K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    cam = JCamera.create(FX, FX, (W - 1) / 2, (H - 1) / 2)
    frames = [j_create_frame(jnp.asarray(i), jnp.asarray(d), cam, n_levels=1)
              for i, d in (synthetic.render(K, lie_np.exp(xi), (H, W)) for xi in
                           (np.zeros(6), XI_MID, XI_CUR))]
    st = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *frames[:2])
    data = jic.precompute_level(st.intensity[0], st.dIx[0], st.dIy[0], st.depth[0], cam, 10.0,
                                max_points=2048)
    rels = [lie_np.exp(XI_OFF) @ lie_np.relative(lie_np.exp(xi), lie_np.exp(XI_CUR))
            for xi in (np.zeros(6), XI_MID)]
    rel = JSE3(jnp.asarray(np.stack([r[:3, :3] for r in rels]), jnp.float32),
               jnp.asarray(np.stack([r[:3, 3] for r in rels]), jnp.float32))
    return data, rel, frames[2].intensity[0], cam


def _inputs(level, F, image_dtype):
    """(JAX args of the Pallas kernels, port args of the plain versions)."""
    data, rel, img, cam = level
    data = jax.tree_util.tree_map(lambda x: x[:F], data)
    rel = JSE3(rel.R[:F], rel.t[:F])
    j_img = img.astype(jnp.bfloat16) if image_dtype == "bfloat16" else img
    pack = jfused_ne.pack_level(data.pcl, data.J, data.templ, data.mask)
    one = lambda tree: jax.tree_util.tree_map(lambda x: np.asarray(x)[None], tree)  # noqa: E731
    t_img = torch.as_tensor(np.array(img))[None]
    if image_dtype == "bfloat16":
        t_img = t_img.to(torch.bfloat16)
    t_cam = interop.camera_from_numpy(jax.tree_util.tree_map(lambda x: np.asarray(x)[None], cam),
                                      device="cpu")
    port = (interop.level_data_from_numpy(one(data), device="cpu"),
            interop.se3_from_numpy(one(rel), device="cpu"), t_img, t_cam)
    return (pack, j_img, rel, cam), port, data.templ.shape[1]


CASES = [(F, interp, dt) for F in (1, 2) for interp in ("nearest", "bilinear")
         for dt in ("float32", "bfloat16")]
IDS = [f"F{F}-{i}-{'bf16' if d == 'bfloat16' else 'f32'}" for F, i, d in CASES]


def _assert_samples_close(iw_t, iw_j, visible, bf16_bilinear):
    if not bf16_bilinear:
        np.testing.assert_allclose(iw_t, iw_j, rtol=0, atol=1e-3)
        return
    d = np.abs(iw_t - iw_j)[visible]
    assert (d <= 2e-3).mean() >= 0.995 and d.max() <= 0.5, ((d <= 2e-3).mean(), d.max())


@pytest.mark.parametrize("F,interp,image_dtype", CASES, ids=IDS)
def test_sample_plain_matches_jax_kernel(level, F, interp, image_dtype):
    jargs, targs, P = _inputs(level, F, image_dtype)
    iw_j, vis_j = jfused_ne.fused_level_sample(*jargs, interp=interp)
    iw_t, vis_t = fused_ne.fused_level_sample_plain(*targs, interp)
    assert iw_t.shape == (1, F, P) and iw_t.dtype == torch.float32 and vis_t.dtype == torch.bool
    vis = vis_t[0].numpy()
    np.testing.assert_array_equal(vis, np.asarray(vis_j)[:, :P])
    assert vis.mean() > 0.5  # a real share of the points is visible
    _assert_samples_close(iw_t[0].numpy(), np.asarray(iw_j)[:, :P], vis,
                          image_dtype == "bfloat16" and interp == "bilinear")


@pytest.mark.parametrize("F,interp,image_dtype", CASES, ids=IDS)
def test_ne_plain_matches_jax_kernel(level, F, interp, image_dtype):
    jargs, targs, _ = _inputs(level, F, image_dtype)
    A_j, b_j, chi2_j, n_j = (np.asarray(x) for x in jfused_ne.fused_level_ne(*jargs, interp=interp))
    A_t, b_t, chi2_t, n_t = (x[0].numpy() for x in fused_ne.fused_level_ne_plain(*targs, interp))
    assert A_t.shape == (F, 6, 6) and b_t.shape == (F, 6) and chi2_t.shape == n_t.shape == (F,)
    np.testing.assert_array_equal(A_t, np.swapaxes(A_t, 1, 2))
    np.testing.assert_allclose(A_t, A_j, rtol=2e-4, atol=1e-3)
    if image_dtype == "bfloat16" and interp == "bilinear":
        np.testing.assert_allclose(b_t, b_j, rtol=0, atol=1e-3 * np.abs(b_j).max())
    else:
        np.testing.assert_allclose(b_t, b_j, rtol=2e-4, atol=1e-2)
    np.testing.assert_allclose(chi2_t, chi2_j, rtol=1e-3)
    np.testing.assert_array_equal(n_t, n_j)


@pytest.mark.parametrize("ctas", [1, fused_ne.NE_CTAS], ids=["one-block", "NE_CTAS"])
def test_ne_plain_in_either_block_order_matches_jax_kernel(level, ctas):
    """The plain NE summing as one block per frame and as the kernel's
    cluster of NE_CTAS blocks: each within the JAX kernel's limits above."""
    jargs, targs, _ = _inputs(level, 2, "float32")
    A_j, b_j, chi2_j, n_j = (np.asarray(x) for x in jfused_ne.fused_level_ne(*jargs, interp="bilinear"))
    A_t, b_t, chi2_t, n_t = (x[0].numpy() for x in fused_ne.fused_level_ne_plain(*targs, "bilinear", ctas=ctas))
    np.testing.assert_allclose(A_t, A_j, rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(b_t, b_j, rtol=2e-4, atol=1e-2)
    np.testing.assert_allclose(chi2_t, chi2_j, rtol=1e-3)
    np.testing.assert_array_equal(n_t, n_j)


def test_ne_plain_block_orders_agree_to_f32_rounding(level):
    """One block per frame and a cluster of NE_CTAS blocks add the same
    ~2000 terms a frame in two orders: every sum within 1e-6 of the largest
    of its kind (A, b, chi2) per frame, 8 f32 ulps of it (the two orders
    differ by at most one such ulp here); the visible count is exact."""
    _, targs, _ = _inputs(level, 2, "float32")
    one = fused_ne.fused_level_ne_plain(*targs, "bilinear", ctas=1)
    many = fused_ne.fused_level_ne_plain(*targs, "bilinear", ctas=fused_ne.NE_CTAS)
    for a, b in zip(one[:3], many[:3]):
        scale = a.abs().reshape(*a.shape[:2], -1).amax(-1).reshape(*a.shape[:2], *[1] * (a.dim() - 2))
        assert bool(((a - b).abs() <= 1e-6 * scale).all()), ((a - b).abs() / scale).max()
    torch.testing.assert_close(one[3], many[3], rtol=0, atol=0)


def test_wrappers_run_the_plain_versions_on_cpu(level):
    """On CPU tensors the wrappers return the plain versions' results and
    launch nothing."""
    _, targs, _ = _inputs(level, 2, "bfloat16")
    before = (fused_ne.SAMPLE_LAUNCHES, fused_ne.NE_LAUNCHES)
    for wrapper, plain in ((fused_ne.fused_level_sample, fused_ne.fused_level_sample_plain),
                           (fused_ne.fused_level_ne, fused_ne.fused_level_ne_plain)):
        for a, b in zip(wrapper(*targs, "bilinear"), plain(*targs, "bilinear")):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (fused_ne.SAMPLE_LAUNCHES, fused_ne.NE_LAUNCHES) == before


def test_bf16_bilinear_rounds_the_row_weights_as_the_tpu_kernel(level):
    """In bf16 image mode the TPU kernel's bilinear row weights (1 - fy, fy)
    are the one-hot matmul's bf16 operand, so it rounds them to bf16, while
    its column weights (1 - fx, fx) stay f32 (`fused_ne.py:170-176,
    193-206`); the port rounds the same way. Held at the bf16 limits of the
    module doc (99.5 % of the visible samples within 2e-3, all within 0.5,
    chi2 within rtol 1e-3). Sampling with both weights in f32 (what the port
    did before) misses both limits by far: a rounded weight moves a 0..255
    sample by up to ~0.5, so most samples differ by more than 2e-3."""
    jargs, targs, P = _inputs(level, 2, "bfloat16")
    iw_j = np.asarray(jfused_ne.fused_level_sample(*jargs, interp="bilinear")[0])[:, :P]
    chi2_j = np.asarray(jfused_ne.fused_level_ne(*jargs, interp="bilinear")[2])
    data, rel, img, cam = targs
    vis = fused_ne.fused_level_sample_plain(*targs, "bilinear")[1][0].numpy()
    # the same samples with f32 row weights, from the f32 copy of the bf16 image
    for image, repaired in ((img, True), (img.float(), False)):
        iw_t = fused_ne.fused_level_sample_plain(data, rel, image, cam, "bilinear")[0][0].numpy()
        chi2_t = fused_ne.fused_level_ne_plain(data, rel, image, cam, "bilinear")[2][0].numpy()
        d = np.abs(iw_t - iw_j)[vis]
        within = bool((d <= 2e-3).mean() >= 0.995 and d.max() <= 0.5
                      and np.all(np.abs(chi2_t - chi2_j) <= 1e-3 * chi2_j))
        assert within == repaired, (repaired, (d <= 2e-3).mean(), d.max(), chi2_t, chi2_j)
