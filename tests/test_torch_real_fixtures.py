"""The port's real-image fixture module (`vslam_tpu_torch.io.real_fixtures`)
against the JAX package's.

The view-synthesis generators are numpy in both packages: on the same
seeded inputs they agree exactly. The loaders read the reference
checkout's shipped fixtures; without them (`available()`,
`trajectory_available()` false, as in `tests/test_real_images.py`) those
tests skip, and both packages agree on whether the files are there.
"""

import numpy as np
import pytest

from vslam_tpu.io import real_fixtures as jrf
from vslam_tpu_torch.core import lie_np
from vslam_tpu_torch.io import real_fixtures as rf
from vslam_tpu_torch.io import synthetic

H, W, FX = 60, 80, 70.0


@pytest.fixture(scope="module")
def frame():
    K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    inten, depth = synthetic.render(K, np.eye(4), (H, W))
    depth = depth.copy()
    depth[10:14, 20:30] = 0.0  # a hole
    depth[40:45, 50:60] += 0.5  # a step
    return K, inten.astype(np.float32), depth.astype(np.float32)


def test_bilinear_and_resize_half(frame):
    _, img, _ = frame
    rng = np.random.default_rng(0)
    u = rng.uniform(-5, W + 5, 500)
    v = rng.uniform(-5, H + 5, 500)
    u[:3] = [np.nan, np.inf, W - 1]
    for a, b in zip(rf.bilinear(img, u, v, fill=-1.0), jrf.bilinear(img, u, v, fill=-1.0)):
        np.testing.assert_array_equal(a, b)
    for times in (1, 2):
        np.testing.assert_array_equal(rf.resize_half(img, times), jrf.resize_half(img, times))


@pytest.mark.parametrize("seed", [1, 2])
def test_warp_rgbd_pair(frame, seed):
    K, img, depth = frame
    rel = lie_np.exp(np.random.default_rng(seed).normal(scale=[0.03, 0.03, 0.03, 0.02, 0.02, 0.02]))
    for a, b in zip(rf.warp_rgbd_pair(img, depth, K, rel), jrf.warp_rgbd_pair(img, depth, K, rel)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [3, 4])
def test_render_plane_texture(frame, seed):
    K, img, _ = frame
    pose = lie_np.exp(np.random.default_rng(seed).normal(scale=[0.1, 0.1, 0.1, 0.05, 0.05, 0.05]))
    for shape in (None, (H // 2, W // 2)):
        a = rf.render_plane_texture(img, K, pose, plane_depth=1.5, shape=shape)
        b = jrf.render_plane_texture(img, K, pose, plane_depth=1.5, shape=shape)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [5, 6])
def test_render_rotated_view(frame, seed):
    K, img, depth = frame
    R = lie_np.rotvec_to_matrix(np.random.default_rng(seed).normal(scale=0.05, size=3))
    for a, b in zip(rf.render_rotated_view(img, depth, K, R), jrf.render_rotated_view(img, depth, K, R)):
        np.testing.assert_array_equal(a, b)
    assert (rf.render_rotated_view(img, depth, K, R)[1] > 0).mean() > 0.5


def test_both_packages_find_the_same_fixtures():
    assert rf.REFERENCE_ROOT == jrf.REFERENCE_ROOT
    assert rf.available() == jrf.available()
    assert rf.trajectory_available() == jrf.trajectory_available()


@pytest.mark.skipif(not rf.available(), reason="reference fixture images not present")
def test_loaders_equal_the_jax_packages():
    for a, b in zip(rf.load_sim(), jrf.load_sim()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rf.load_person(), jrf.load_person())
    for a, b in zip(rf.load_rgbd_pair(), jrf.load_rgbd_pair()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.skipif(not rf.trajectory_available(), reason="reference trajectory fixture not present")
def test_trajectory_window_equals_the_jax_packages():
    for a, b in zip(rf.real_trajectory_window(16), jrf.real_trajectory_window(16)):
        np.testing.assert_array_equal(a, b)
