"""The port's feature modules (`vslam_tpu_torch.features`: detector,
descriptor, matcher, tracking) against the JAX package's, on the same numpy
inputs from a seed.

Tolerances:
* detector: on integer-valued images every FAST term is an integer, so the
  ring stack, the scores, the cell argmax and the keypoints are exact, and
  a batch of images detects as each image alone;
* descriptor: pack / unpack / as_float_bits and the unoriented descriptors
  exact; orientations within 1e-5 rad of JAX's on the blob images, and
  within 1e-6 rad of the exactly summed moments' angle on every image (see
  `test_orientations_and_descriptors` for the box frames, where JAX's own
  f32 sums stray by 1.5e-5 rad); the steered descriptors at least 99 %
  equal bits (an angle differing in its last bits can move a rounded test
  offset that sits at .5);
* matcher: the L1 matrix exact (sums of 0/1 products); reprojection and
  epipolar distances within 1e-4 px; `ratio_match` (with and without
  `unique`, on a tie case and on real descriptors) exact;
* tracking: `_detect_describe` exact in keypoints and within the
  descriptor tolerance; `track` and `track_batch` give the same landmark
  associations (kp_landmark up to renaming the ids) and landmark positions
  within 1e-9 m (host f64 math on the same keypoints).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.core.camera import Camera as JCamera
from vslam_tpu.core.frame import create_frame as jcreate_frame
from vslam_tpu.features import descriptor as jdesc
from vslam_tpu.features import detector as jdet
from vslam_tpu.features import matcher as jmatch
from vslam_tpu.features import tracking as jtrack
from vslam_tpu.odometry import map as jmap
from vslam_tpu_torch.core import lie_np
from vslam_tpu_torch.core.camera import Camera
from vslam_tpu_torch.core.frame import create_frame
from vslam_tpu_torch.features import descriptor, detector, matcher, tracking
from vslam_tpu_torch.io import synthetic
from vslam_tpu_torch.odometry import map as tmap
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

H, W, FX = 120, 160, 140.0
CX, CY = (W - 1) / 2, (H - 1) / 2


def blob_image(rng, n=25):
    """Integer-valued image with bright square blobs (FAST corners at their corners)."""
    img = np.full((H, W), 50.0, np.float32)
    centers = []
    for _ in range(n):
        y, x = rng.integers(20, H - 20), rng.integers(20, W - 20)
        img[y - 3 : y + 4, x - 3 : x + 4] = 220.0
        centers.append((x, y))
    return img, centers


def box_frames(n=3):
    """Integer box-scene frames along a short sweep, with their poses."""
    K = synthetic.camera_matrix(FX, FX, CX, CY)
    scene = synthetic.BoxScene(seed=4)
    poses = [lie_np.exp(np.array([0.02 * k, 0.0, 0.0, 0.0, 0.01 * k, 0.0])) for k in range(n)]
    out = []
    for p in poses:
        inten, depth = synthetic.render_boxes(K, p, (H, W), scene)
        out.append((np.round(inten).astype(np.float32), depth))
    return poses, out


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(42)
    blobs = [blob_image(rng) for _ in range(2)]
    _, boxes = box_frames(2)
    return [b[0] for b in blobs] + [f[0] for f in boxes], [b[1] for b in blobs]


def test_ring_stack_and_scores_exact(images):
    for img in images[0]:
        ring_j = np.asarray(jdet._ring_stack(jnp.asarray(img)))
        ring_t = detector._ring_stack(torch.from_numpy(img)).numpy()
        np.testing.assert_array_equal(ring_t, ring_j)
        for thr in (10.0, 20.0):
            np.testing.assert_array_equal(detector.fast_score(torch.from_numpy(img), thr).numpy(),
                                          np.asarray(jdet.fast_score(jnp.asarray(img), thr)))


@pytest.mark.parametrize("threshold,cell,border", [(10.0, 30, 16), (20.0, 16, 24), (10.0, 20, 24)])
def test_fast_grid_detect_exact_and_batched(images, threshold, cell, border):
    imgs = np.stack(images[0])
    depth = np.full(imgs.shape, 2.0, np.float32)
    depth[:, :, : W // 4] = 0.0  # invalid depth masks a quarter of every image
    batched = detector.fast_grid_detect(torch.from_numpy(imgs), torch.from_numpy(depth), threshold=threshold,
                                        cell=cell, border=border)
    for i in range(len(imgs)):
        want = jdet.fast_grid_detect(jnp.asarray(imgs[i]), jnp.asarray(depth[i]), threshold=threshold, cell=cell,
                                     border=border)
        got = detector.fast_grid_detect(torch.from_numpy(imgs[i]), torch.from_numpy(depth[i]),
                                        threshold=threshold, cell=cell, border=border)
        for g, b, w in zip(got, batched, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            np.testing.assert_array_equal(b[i].numpy(), np.asarray(w))
    assert int(batched.valid.sum()) > 10


def test_pack_unpack_exact():
    rng = np.random.default_rng(3)
    bits = (rng.random((2, 17, descriptor.N_BITS)) < 0.5).astype(np.float32)
    packed = descriptor.pack_bits(torch.from_numpy(bits)).numpy()
    assert packed.dtype == np.uint8 and packed.shape == (2, 17, descriptor.N_BYTES)
    for i in range(2):
        np.testing.assert_array_equal(packed[i], np.asarray(jdesc.pack_bits(jnp.asarray(bits[i]))))
        np.testing.assert_array_equal(descriptor.unpack_bits(torch.from_numpy(packed[i])).numpy(),
                                      np.asarray(jdesc.unpack_bits(jnp.asarray(packed[i]))))
        np.testing.assert_array_equal(descriptor.as_float_bits(packed[i]), jdesc.as_float_bits(packed[i]))
    np.testing.assert_array_equal(descriptor.unpack_bits(torch.from_numpy(packed)).numpy(), bits)
    np.testing.assert_array_equal(descriptor.brief_pattern(), jdesc.brief_pattern())
    np.testing.assert_array_equal(descriptor._ORI_DX, jdesc._ORI_DX)


def _keypoints(img):
    det = jdet.fast_grid_detect(jnp.asarray(img), jnp.full(img.shape, 2.0), cell=16, border=descriptor.PATCH)
    return np.asarray(det.uv)[np.asarray(det.valid)]


def _exact_orientations(smooth: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """The centroid angles from moments summed exactly (f64: every product
    of a dyadic blurred intensity and an integer offset is exact), rounded
    to f32 before the atan2 as the packages' f32 moments are."""
    Hs, Ws = smooth.shape
    u, v = uv[:, 0].astype(int), uv[:, 1].astype(int)
    p = smooth.astype(np.float64)[np.clip(v[:, None] + descriptor._ORI_DY, 0, Hs - 1),
                                  np.clip(u[:, None] + descriptor._ORI_DX, 0, Ws - 1)]
    m10 = (p * descriptor._ORI_DX).sum(1).astype(np.float32)
    m01 = (p * descriptor._ORI_DY).sum(1).astype(np.float32)
    return np.arctan2(m01, m10)


def test_orientations_and_descriptors(images):
    """Orientations: on the blob images within 1e-5 rad of JAX's. On the box
    frames, keypoints with moments down to |m| ~ 1.6e3 make the JAX
    function's f32 sums of ~700 terms differ from the exactly summed moments
    by up to 1.5e-5 rad (its reduction order); there the port is held to the
    exact angle within 1e-6 rad (its own error is ~2e-7), and so on every
    image."""
    equal, total = 0, 0
    blobs = len(images[1])
    for k, img in enumerate(images[0]):
        uv = _keypoints(img)
        assert len(uv) >= 5
        smooth_j = jdesc.img_ops.gaussian_blur_3x3(jdesc.img_ops.gaussian_blur_3x3(jnp.asarray(img)))
        smooth_t = descriptor.img_ops.gaussian_blur_3x3(descriptor.img_ops.gaussian_blur_3x3(torch.from_numpy(img)))
        np.testing.assert_array_equal(smooth_t.numpy(), np.asarray(smooth_j))  # exact: dyadic weights
        th_j = np.asarray(jdesc.keypoint_orientations(smooth_j, jnp.asarray(uv)))
        th_t = descriptor.keypoint_orientations(smooth_t, torch.from_numpy(uv)).numpy()
        np.testing.assert_allclose(th_t, _exact_orientations(smooth_t.numpy(), uv), atol=1e-6, rtol=0)
        if k < blobs:
            np.testing.assert_allclose(th_t, th_j, atol=1e-5, rtol=0)
        d_j = np.asarray(jdesc.extract_descriptors(jnp.asarray(img), jnp.asarray(uv)))
        d_t = descriptor.extract_descriptors(torch.from_numpy(img), torch.from_numpy(uv)).numpy()
        equal += int((d_t == d_j).sum())
        total += d_j.size
        np.testing.assert_array_equal(
            descriptor.extract_descriptors(torch.from_numpy(img), torch.from_numpy(uv), oriented=False).numpy(),
            np.asarray(jdesc.extract_descriptors(jnp.asarray(img), jnp.asarray(uv), oriented=False)))
        # a batch of two copies describes as one image
        two = descriptor.extract_descriptors(torch.from_numpy(np.stack([img, img])),
                                             torch.from_numpy(np.stack([uv, uv])))
        np.testing.assert_array_equal(two[1].numpy(), d_t)
    assert equal / total >= 0.99, equal / total


def test_matcher_matrices():
    rng = np.random.default_rng(5)
    dq = (rng.random((2, 13, 256)) < 0.5).astype(np.float32)
    dc = (rng.random((2, 9, 256)) < 0.5).astype(np.float32)
    got = matcher.descriptor_l1_matrix(torch.from_numpy(dq), torch.from_numpy(dc)).numpy()
    for i in range(2):
        np.testing.assert_array_equal(got[i], np.asarray(jmatch.descriptor_l1_matrix(jnp.asarray(dq[i]),
                                                                                     jnp.asarray(dc[i]))))
    p3d = np.concatenate([rng.uniform(-1, 1, (9, 2)), rng.uniform(-0.5, 3.0, (9, 1))], 1).astype(np.float32)
    uv = rng.uniform(0, 100, (13, 2)).astype(np.float32)
    np.testing.assert_allclose(
        matcher.reprojection_error_matrix(torch.from_numpy(p3d), torch.from_numpy(uv), FX, FX, CX, CY,
                                          invalid_value=-1.0).numpy(),
        np.asarray(jmatch.reprojection_error_matrix(jnp.asarray(p3d), jnp.asarray(uv), FX, FX, CX, CY,
                                                    invalid_value=-1.0)), atol=1e-4, rtol=0)
    F = rng.normal(size=(3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        matcher.epipolar_error_matrix(torch.from_numpy(F), torch.from_numpy(uv), torch.from_numpy(uv[:9])).numpy(),
        np.asarray(jmatch.epipolar_error_matrix(jnp.asarray(F), jnp.asarray(uv), jnp.asarray(uv[:9]))),
        atol=1e-4, rtol=1e-5)
    Kc = synthetic.camera_matrix(FX, FX, CX, CY).astype(np.float32)
    rel = lie_np.exp(np.array([0.1, 0.02, 0.0, 0.01, 0.03, 0.0])).astype(np.float32)
    np.testing.assert_allclose(
        matcher.fundamental_matrix(torch.from_numpy(Kc), torch.from_numpy(rel), torch.from_numpy(Kc)).numpy(),
        np.asarray(jmatch.fundamental_matrix(jnp.asarray(Kc), jnp.asarray(rel), jnp.asarray(Kc))),
        rtol=1e-4, atol=1e-9)


TIE = np.array([
    [1.0, 10.0, 20.0, 30.0],   # candidate 0, distance 1
    [1.0, 12.0, 25.0, 31.0],   # candidate 0 again at the same distance: the lower query index wins
    [30.0, 2.0, 2.0, 40.0],    # two equal best: argmin takes the first, the ratio test rejects
    [9.0, 30.0, 40.0, 0.5],    # candidate 3
    [40.0, 40.0, 5.0, 0.5],    # candidate 3 at the same distance as query 3
    [2000.0, 3000.0, 4000.0, 5000.0],  # beyond the maximum distance
], np.float32)


@pytest.mark.parametrize("unique", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_ratio_match_ties(unique, masked):
    kw = {}
    if masked:
        kw = {"mask_q": np.array([True, True, True, True, True, False]),
              "mask_c": np.array([True, True, False, True])}
    got = matcher.ratio_match(torch.from_numpy(TIE), **{k: torch.from_numpy(v) for k, v in kw.items()},
                              unique=unique)
    want = jmatch.ratio_match(jnp.asarray(TIE), **{k: jnp.asarray(v) for k, v in kw.items()}, unique=unique)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if unique and not masked:
        assert list(got.valid.numpy()) == [True, False, False, True, False, False]


def test_ratio_match_on_descriptors(images):
    img = images[0][0]
    uv = _keypoints(img)
    d1 = descriptor.extract_descriptors(torch.from_numpy(img), torch.from_numpy(uv))
    d2 = descriptor.extract_descriptors(torch.from_numpy(np.roll(img, (2, 2), (0, 1))), torch.from_numpy(uv + 2))
    dm = matcher.descriptor_l1_matrix(d1, d2)
    got = matcher.ratio_match(dm, max_distance=80.0, unique=True)
    want = jmatch.ratio_match(jnp.asarray(dm.numpy()), max_distance=80.0, unique=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.valid.sum() >= 5


def test_detect_describe_matches_jax():
    _, frames = box_frames(1)
    inten, depth = frames[0]
    got = tracking._detect_describe(torch.from_numpy(inten), torch.from_numpy(depth), cell=16)
    want = jtrack._detect_describe(jnp.asarray(inten), jnp.asarray(depth), cell=16)
    for i in (0, 1, 2, 4):  # uv, response, valid, depth: exact
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    bits_t = np.unpackbits(got[3].numpy(), axis=-1)
    bits_j = np.unpackbits(np.asarray(want[3]), axis=-1)
    valid = got[2].numpy()
    assert valid.sum() >= 10
    assert (bits_t[valid] == bits_j[valid]).mean() >= 0.99


def _host_frames(poses, frames, port: bool):
    """HostFrames of the box frames for one package, at their true poses."""
    out = []
    for i, (p, (inten, depth)) in enumerate(zip(poses, frames)):
        if port:
            f = create_frame(torch.from_numpy(inten), torch.from_numpy(depth),
                             Camera.create(FX, FX, CX, CY, device="cpu"), n_levels=1)
            out.append(tmap.HostFrame(frame=f, t_ns=i, pose=np.asarray(p, np.float64)))
        else:
            f = jcreate_frame(jnp.asarray(inten), jnp.asarray(depth), JCamera.create(FX, FX, CX, CY), n_levels=1)
            out.append(jmap.HostFrame(frame=f, t_ns=i, pose=np.asarray(p, np.float64)))
    return out


def _canonical(kp_landmarks):
    """kp_landmark arrays with landmark ids renamed in order of first appearance."""
    names = {}
    out = []
    for kl in kp_landmarks:
        out.append([-1 if x < 0 else names.setdefault(int(x), len(names)) for x in kl])
    return out


def _track_both(schedule):
    poses, frames = box_frames(4)
    res = {}
    for port in (False, True):
        hf = _host_frames(poses, frames, port)
        if port:
            ft = tracking.FeatureTracking(grid_cell=16, device="cpu")
            m = tmap.Map()
        else:
            ft = jtrack.FeatureTracking(grid_cell=16)
            m = jmap.Map()
        for f in hf:
            ft.extract(f)
        if schedule == "track":
            for f in hf:
                m.insert(f, True)
                m.insert_points(ft.track(f, m))
        else:
            m.insert(hf[0], True)
            ft.track_batch(hf[1:], m)
            for f in hf[1:]:
                m.insert(f, True)
        res[port] = (hf, m)
    return res


@pytest.mark.parametrize("schedule", ["track", "track_batch"])
def test_tracking_associations_match_jax(schedule):
    res = _track_both(schedule)
    (hj, mj), (ht, mt) = res[False], res[True]
    for fj, ft in zip(hj, ht):
        np.testing.assert_array_equal(ft.keypoints, fj.keypoints)
    assert _canonical([f.kp_landmark for f in ht]) == _canonical([f.kp_landmark for f in hj])
    pj = sorted(tuple(np.round(p.position, 9)) for p in mj.points())
    pt = sorted(tuple(np.round(p.position, 9)) for p in mt.points())
    assert len(pt) == len(pj) > 5
    np.testing.assert_allclose(np.asarray(pt), np.asarray(pj), atol=1e-9)
