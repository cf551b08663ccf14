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
    tf = interop.frame_from_numpy(frame)
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
    tfs = [interop.frame_from_numpy(f) for f in frames]
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
    td = interop.level_data_from_numpy(jd)
    assert td.mask.dtype == torch.bool and td.pcl.dtype == torch.float32
    _compare(jd, td)
