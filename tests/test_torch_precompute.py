"""Parity of the port's interest-point precompute (`ic.precompute_level`)
with the JAX package, dense and compact.

The selected point set must be the same, so the mask and n_constraints are
compared exactly, including the compact path's under-selection (capacity
nb * (n_sel // nb), `vslam_tpu/alignment/ic.py:320`) and its kb = 1 clamp.
pcl within rtol 1e-5; J within rtol 1e-4 / atol 1e-3 (products of f32
gradients and Jacobian rows)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.alignment import ic as jic
from vslam_tpu.core.camera import Camera as JCamera
from vslam_tpu.core.frame import create_frame as j_create_frame
from vslam_tpu.io import synthetic
from vslam_tpu_torch import interop
from vslam_tpu_torch.alignment import ic as tic
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)


def _frame(H, W, seed):
    fx = 525.0 * W / 640
    K = synthetic.camera_matrix(fx, fx, (W - 1) / 2, (H - 1) / 2)
    pose = synthetic.lie_np.exp(np.array([0.01, 0.02, -0.01, 0.01, -0.02, 0.01]) * seed)
    inten, depth = synthetic.render(K, pose, (H, W), synthetic.default_scene(seed))
    depth = depth.copy()
    depth[H // 3 : H // 3 + 4, W // 2 : W // 2 + 6] = 0.0  # a hole: 3x3 erosion
    depth[H - 5, 7] = np.nan
    cam = JCamera.create(fx, fx, (W - 1) / 2, (H - 1) / 2)
    frame = j_create_frame(jnp.asarray(inten), jnp.asarray(depth), cam, n_levels=2)
    return jax.tree_util.tree_map(np.asarray, frame)


def _compare(jd, td):
    np.testing.assert_array_equal(td.mask.numpy(), jd.mask)
    np.testing.assert_array_equal(td.n_constraints.numpy(), jd.n_constraints)
    assert tuple(td.pcl.shape) == jd.pcl.shape
    np.testing.assert_allclose(td.pcl.numpy(), jd.pcl, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(td.J.numpy(), jd.J, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(td.templ.numpy(), jd.templ, rtol=1e-6)


def _jax_level(frame, level, min_gradient, max_points):
    cam = JCamera(*(jnp.asarray(c) for c in frame.cameras[level]))
    out = jic.precompute_level(
        jnp.asarray(frame.intensity[level]), jnp.asarray(frame.dIx[level]),
        jnp.asarray(frame.dIy[level]), jnp.asarray(frame.depth[level]), cam,
        min_gradient, max_points=max_points,
    )
    return jax.tree_util.tree_map(np.asarray, out)


def _torch_level(frame, level, min_gradient, max_points):
    tf = interop.frame_from_numpy(frame, device="cpu")
    return tic.precompute_level(
        tf.intensity[level], tf.dIx[level], tf.dIy[level], tf.depth[level],
        tf.cameras[level], min_gradient, max_points=max_points,
    )


@pytest.mark.parametrize(
    "H,W,level,min_gradient,max_points",
    [
        (37, 53, 0, 10.0, 0),  # dense, odd size
        (48, 64, 1, 5.0, 0),  # dense, coarse level
        (48, 64, 0, 10.0, 1024),  # compact: 24 blocks x 42
        (48, 64, 0, 30.0, 96),  # compact: tight budget, 4 per block
        (48, 64, 0, 10.0, 10),  # compact: n_sel < nb, kb clamped to 1
        (37, 53, 0, 10.0, 300),  # compact: odd H, the last block padded
        (37, 53, 1, 10.0, 40),  # compact at level 1 (19x27)
    ],
)
def test_precompute_level_matches_jax(H, W, level, min_gradient, max_points):
    frame = _frame(H, W, seed=1)
    jd = _jax_level(frame, level, min_gradient, max_points)
    td = _torch_level(frame, level, min_gradient, max_points)
    if max_points:
        assert td.templ.shape[-1] < H * W >> (2 * level)  # compact capacity, not the grid
    assert jd.n_constraints > 6
    _compare(jd, td)


def test_precompute_level_batched_over_pairs_and_frames():
    """(B, F, H, W) inputs with per-pair (B,) cameras give, per slice, the
    JAX result of that single frame."""
    frames = [_frame(48, 64, seed=s) for s in (1, 2, 3, 4)]
    tfs = [interop.frame_from_numpy(f, device="cpu") for f in frames]
    level, grad, budget = 0, 10.0, 512

    def stack(name):
        x = torch.stack([getattr(f, name)[level] for f in tfs])
        return x.reshape(2, 2, *x.shape[1:])

    cams = tfs[0].cameras[level]
    cam_b = type(cams)(*(c.expand(2).clone() for c in cams))
    td = tic.precompute_level(stack("intensity"), stack("dIx"), stack("dIy"), stack("depth"),
                              cam_b, grad, max_points=budget)
    for k, frame in enumerate(frames):
        jd = _jax_level(frame, level, grad, budget)
        _compare(jd, type(td)(*(x[k // 2, k % 2] for x in td)))


def test_interop_level_data_roundtrip():
    frame = _frame(48, 64, seed=2)
    jd = _jax_level(frame, 0, 10.0, 256)
    td = interop.level_data_from_numpy(jd, device="cpu")
    assert td.mask.dtype == torch.bool and td.pcl.dtype == torch.float32
    _compare(jd, td)


def test_standardize_and_normalize_level_match_jax():
    """The exposure-robust mode's per-image standardization over valid
    (nonzero) pixels, on a batch of two images."""
    frames = [_frame(48, 64, seed=s) for s in (1, 2)]
    inten = np.stack([f.intensity[0] for f in frames])
    dIx = np.stack([f.dIx[0] for f in frames])
    dIy = np.stack([f.dIy[0] for f in frames])
    inten[0, :5] = 0.0  # invalid rows: excluded from the statistics
    got = tic.normalize_level(*map(torch.as_tensor, (inten, dIx, dIy)))
    want = jic.normalize_level(*map(jnp.asarray, (inten, dIx, dIy)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(tic._standardize(torch.as_tensor(inten)).numpy(),
                               np.asarray(jic._standardize(jnp.asarray(inten))), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("normalize", [False, True])
def test_precompute_frame_matches_jax(normalize):
    """Every level of one frame, with and without normalize_intensity; the
    port keeps the frame's leading axes (here none)."""
    frame = _frame(48, 64, seed=3)
    jcfg = jic.AlignmentConfig(min_gradient=10.0, max_points=1024, normalize_intensity=normalize)
    jframe = jax.tree_util.tree_map(jnp.asarray, frame)
    want = jax.tree_util.tree_map(np.asarray, jic.precompute_frame(jframe, jcfg))
    got = tic.precompute_frame(interop.frame_from_numpy(frame, device="cpu"),
                               tic.AlignmentConfig(min_gradient=10.0, max_points=1024,
                                                   normalize_intensity=normalize))
    assert len(got) == len(want) == 2
    for jd, td in zip(want, got):
        np.testing.assert_array_equal(td.mask.numpy(), jd.mask)
        np.testing.assert_allclose(td.pcl.numpy(), jd.pcl, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(td.J.numpy(), jd.J, rtol=1e-4, atol=1e-2 if normalize else 1e-3)
        np.testing.assert_allclose(td.templ.numpy(), jd.templ, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("normalize", [False, True])
def test_align_with_cached_ref_data_equals_uncached(normalize):
    """`align(None, cur, ..., ref_data=precompute_frame(...))` gives the
    result of `align(ref, cur, ...)`, also in the exposure-robust mode
    (then against the JAX package too, pose within 1e-3)."""
    from vslam_tpu.core.se3 import SE3 as JSE3
    from vslam_tpu_torch.core.se3 import SE3
    from vslam_tpu_torch.utils.tree import tree_map

    f_ref, f_cur = _frame(48, 64, seed=0), _frame(48, 64, seed=1)
    kw = dict(min_gradient=10.0, max_points=1024, normalize_intensity=normalize,
              prior_weight=(525.0 * 64 / 640 / 525.0) ** 2)
    cfg = tic.AlignmentConfig(**kw)
    ref = tree_map(lambda x: x[None, None], interop.frame_from_numpy(f_ref, device="cpu"))
    cur = tree_map(lambda x: x[None], interop.frame_from_numpy(f_cur, device="cpu"))
    rel0 = SE3(torch.eye(3)[None, None], torch.zeros(1, 1, 3))
    xp = torch.zeros(1, 1, 6)
    plain = tic.align(ref, cur, rel0, xp, cfg)
    data = tuple(tree_map(lambda x: x[:, None], d)
                 for d in tic.precompute_frame(tree_map(lambda x: x[0], ref), cfg))
    cached = tic.align(None, cur, rel0, xp, cfg, ref_data=data)
    for a, b in zip(plain, cached):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    if normalize:
        jref = jax.tree_util.tree_map(lambda x: jnp.asarray(x)[None], f_ref)
        jcur = jax.tree_util.tree_map(jnp.asarray, f_cur)
        rel, _, ok = jic.align(jref, jcur, JSE3(jnp.eye(3)[None], jnp.zeros((1, 3))),
                               jnp.zeros((1, 6)), jic.AlignmentConfig(**kw))
        assert bool(ok) and bool(plain[2][0])
        np.testing.assert_allclose(plain[0].t[0].numpy(), np.asarray(rel.t), atol=1e-3)
        np.testing.assert_allclose(plain[0].R[0].numpy(), np.asarray(rel.R), atol=1e-3)
