"""The port's KITTI stereo path (`vslam_tpu_torch.io.kitti` and the stereo
branch of `odometry.sequential`) against the JAX package's.

* The block matcher on the scenes of `tests/test_kitti.py` (96x160 at
  constant disparity, D = 32; the 128x192 slanted plane and box scene,
  D = 64), `lr_check` on and off. Bit for bit against the JAX function run
  op by op (`jax.disable_jit`, the constant scene: its compile per op
  shape costs seconds): both sum the box filter in the same tap order.
  The jitted JAX function is not bit-equal: XLA fuses the box filter and
  contracts its multiply-adds, so its costs differ in the last bits, and
  the parabolic refinement amplifies that where the parabola is flat (4 of
  22,154 valid pixels of the box scene without the left-right check differ
  by 3.2e-5 px). Against it: validity equal on >= 99.9 % of pixels,
  disparity within 1e-4 px where both are valid; the test prints the count
  of pixels that differ.
* The JAX tests' accuracy checks run on the port: median error at constant
  disparity, depth conversion, textureless rejection, slanted-plane RMSE
  < 0.5 px, the left-right check's occlusion leak.
* ``fx`` of shape (S,), S = 3 with different focal lengths: each pair's
  depth equals a call with its own scalar fx, bit for bit.
* The stereo scan: 8 frames of a 96x128 stereo stream (baseline 0.3 m, D =
  32, chunk 4) through `SequentialOdometry` of both packages. The
  tolerances of `tests/test_torch_sequential.py`: per-frame pose within
  1e-3, `valid` and keyframe flags equal, covariance within rtol 1e-2 of
  its largest entry.
* `KittiDataset` on a mini-KITTI tree (PNG files): calibration, baseline,
  times, ground truth equal to JAX's to 1e-12; `iter_stereo` images equal;
  `__iter__` depth within 1e-4 m where both are valid, validity equal on
  >= 99.9 % of pixels.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vslam_tpu.alignment.ic import AlignmentConfig as JAlignmentConfig
from vslam_tpu.core import image as jimg
from vslam_tpu.core.camera import Camera as JCamera
from vslam_tpu.io import kitti as jkitti
from vslam_tpu.odometry import sequential as jseq
from vslam_tpu.solvers import SolverConfig as JSolverConfig
from vslam_tpu_torch import interop
from vslam_tpu_torch.core import image as timg
from vslam_tpu_torch.core import lie_np
from vslam_tpu_torch.core.camera import Camera
from vslam_tpu_torch.eval import metrics
from vslam_tpu_torch.io import kitti as tkitti
from vslam_tpu_torch.io import synthetic
from vslam_tpu_torch.odometry import sequential as tseq
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

H, W, FX = 96, 128, 110.0
CX, CY = (W - 1) / 2, (H - 1) / 2
N_FRAMES = 8
CHUNK = 4
DT_NS = int(1e9 / 10)
BASELINE = 0.3


def _stereo_pair(rng, H=96, W=160, disp=7.0):
    """`tests/test_kitti.py`'s fronto-parallel plane: right(x) = left(x + d)."""
    from scipy.ndimage import zoom

    base = zoom(rng.uniform(0, 255, (H // 4, (W + 40) // 4)), 4, order=3)[:H, : W + 40]
    left = base[:, 20 : 20 + W].astype(np.float32)
    right = base[:, int(20 + disp) : int(20 + disp) + W].astype(np.float32)
    return left, right


def _render_stereo(scene_render, K, baseline, shape, pose=None):
    """A rectified pair, the right camera `baseline` along the left one's +x,
    and the closed-form disparity fx * b / z of the left view."""
    left_pose = np.eye(4) if pose is None else pose
    shift = np.eye(4)
    shift[0, 3] = -baseline
    il, zl = scene_render(K, left_pose, shape)
    ir, _ = scene_render(K, shift @ left_pose, shape)
    d_true = np.where(zl > 0, K[0, 0] * baseline / np.maximum(zl, 1e-6), 0.0)
    return il, ir, d_true.astype(np.float32)


def _scene(name):
    """(left, right, true disparity or None, max_disparity) of a JAX test scene."""
    if name == "constant":
        left, right = _stereo_pair(np.random.default_rng(42), disp=7.0)
        return left, right, np.full(left.shape, 7.0, np.float32), 32
    Hs, Ws, fx = 128, 192, 160.0
    K = synthetic.camera_matrix(fx, fx, (Ws - 1) / 2, (Hs - 1) / 2)
    if name == "slanted":
        scene = synthetic.PlaneScene(normal=(0.35, 0.1, 1.0), d=2.0)
        return (*_render_stereo(lambda k, p, s: synthetic.render(k, p, s, scene), K, 0.3, (Hs, Ws)), 64)
    scene = synthetic.BoxScene(seed=3)
    return (*_render_stereo(lambda k, p, s: synthetic.render_boxes(k, p, s, scene), K, 0.4, (Hs, Ws)), 64)


SCENES = ("constant", "slanted", "box")


@pytest.fixture(scope="module")
def scenes():
    return {name: _scene(name) for name in SCENES}


def _port_disp(left, right, **kw):
    return tkitti.block_matching_disparity(torch.from_numpy(left), torch.from_numpy(right), **kw).numpy()


def _jax_disp(left, right, **kw):
    return np.asarray(jkitti.block_matching_disparity(jnp.asarray(left), jnp.asarray(right), **kw))


def _assert_disparity_close(got, want, what):
    both = (got > 0) & (want > 0)
    n_valid_diff = int(((got > 0) != (want > 0)).sum())
    n_diff = int((got != want).sum())
    print(f"{what}: {n_diff} of {got.size} pixels differ, {n_valid_diff} in validity, "
          f"max |d disp| {np.abs(got - want)[both].max(initial=0.0):.3e} px where both are valid")
    assert n_valid_diff <= 1e-3 * got.size
    np.testing.assert_allclose(got[both], want[both], rtol=0, atol=1e-4)


@pytest.mark.parametrize("lr_check", [True, False], ids=["lr", "no-lr"])
@pytest.mark.parametrize("name", SCENES)
def test_block_matching_matches_jax(scenes, name, lr_check):
    left, right, _, D = scenes[name]
    got = _port_disp(left, right, max_disparity=D, lr_check=lr_check)
    want = _jax_disp(left, right, max_disparity=D, lr_check=lr_check)
    assert got.shape == want.shape == left.shape and got.dtype == np.float32
    assert (got > 0).mean() > 0.3
    _assert_disparity_close(got, want, f"{name} lr_check={lr_check}")


@pytest.mark.parametrize("lr_check", [True, False], ids=["lr", "no-lr"])
def test_block_matching_equals_jax_op_by_op(scenes, lr_check):
    import jax

    left, right, _, D = scenes["constant"]
    with jax.disable_jit():
        want = _jax_disp(left, right, max_disparity=D, lr_check=lr_check)
    np.testing.assert_array_equal(_port_disp(left, right, max_disparity=D, lr_check=lr_check), want)


def test_box_filter_equals_the_jax_one_op_by_op(scenes):
    """The box filter of a (D, H, W) cost volume sums its taps in the JAX
    filter's order: bit for bit against it run op by op, one slice at a time."""
    left, right, _, D = scenes["slanted"]
    taps = (1.0 / 9,) * 9
    cost = np.abs(left[None] - np.stack([np.pad(right, ((0, 0), (d, 0)))[:, : right.shape[1]]
                                         for d in (0, 5, D - 1)])).astype(np.float32)
    got = timg._sep_conv_reflect(torch.from_numpy(cost), taps, taps).numpy()
    for k in range(3):
        np.testing.assert_array_equal(got[k], np.asarray(jimg._sep_conv_reflect(jnp.asarray(cost[k]), taps, taps)))


def test_stereo_depth_matches_jax(scenes):
    left, right, _, _ = scenes["constant"]
    got = tkitti.stereo_depth(torch.from_numpy(left), torch.from_numpy(right), 100.0, 0.5,
                              max_disparity=32).numpy()
    want = np.asarray(jkitti.stereo_depth(jnp.asarray(left), jnp.asarray(right), 100.0, 0.5, max_disparity=32))
    both = (got > 0) & (want > 0)
    assert ((got > 0) != (want > 0)).sum() <= 1e-3 * got.size
    np.testing.assert_allclose(got[both], want[both], rtol=1e-5)


def test_constant_disparity_plane(scenes):
    left, right, _, _ = scenes["constant"]
    disp = _port_disp(left, right, max_disparity=32)
    interior = np.zeros(disp.shape, bool)
    interior[10:-10, 40:-10] = True
    sel = (disp > 0) & interior
    assert sel.mean() > 0.3
    assert np.median(np.abs(disp[sel] - 7.0)) < 0.5


def test_depth_conversion():
    left, right = _stereo_pair(np.random.default_rng(42), disp=8.0)
    depth = tkitti.stereo_depth(torch.from_numpy(left), torch.from_numpy(right), 100.0, 0.5,
                                max_disparity=32).numpy()
    sel = depth > 0
    assert sel.mean() > 0.2
    assert abs(np.median(depth[sel]) - 100.0 * 0.5 / 8.0) < 0.5


def test_textureless_is_invalid():
    flat = np.full((64, 96), 100.0, np.float32)
    assert (_port_disp(flat, flat, max_disparity=16) > 0).mean() < 0.05


def test_slanted_plane_disparity_rmse(scenes):
    left, right, d_true, _ = scenes["slanted"]
    disp = _port_disp(left, right, max_disparity=64)
    interior = np.zeros(disp.shape, bool)
    interior[8:-8, 70:-8] = True
    sel = (disp > 0) & interior & (d_true > 0)
    assert sel.mean() > 0.35
    assert float(np.sqrt(np.mean((disp[sel] - d_true[sel]) ** 2))) < 0.5


def test_lr_consistency_rejects_occlusions(scenes):
    """`tests/test_kitti.py`'s z-buffer occlusion truth: the left-right gate
    rejects most occluded pixels, and is what rejects them."""
    left, right, d_true, _ = scenes["box"]
    Hs, Ws = left.shape
    occluded = np.zeros((Hs, Ws), bool)
    xs = np.arange(Ws)
    for y in range(Hs):
        d = d_true[y]
        xr = np.round(xs - d).astype(int)
        ok = (d > 0) & (xr >= 0)
        best = np.full(Ws, -1.0)
        for x in xs[ok]:
            best[xr[x]] = max(best[xr[x]], d[x])
        occluded[y, ok] = d[ok] < best[xr[ok]] - 1.0
    interior = np.zeros((Hs, Ws), bool)
    interior[8:-8, 70:-8] = True
    occ = occluded & interior
    assert occ.sum() > 50
    leak_lr = (_port_disp(left, right, max_disparity=64, lr_check=True)[occ] > 0).mean()
    leak_no = (_port_disp(left, right, max_disparity=64, lr_check=False)[occ] > 0).mean()
    assert leak_lr < 0.25 and leak_no > 2 * leak_lr, (leak_lr, leak_no)


def test_batched_pairs_take_one_fx_each(scenes):
    """(S, H, W) pairs with fx of shape (S,), S = 3 (the first two pairs the
    same, the third another): each pair's depth is that of its own call with
    a scalar fx, and the same pair's depth scales with fx."""
    left, right, _, D = scenes["slanted"]
    l3 = np.stack([left, left, np.roll(left, 3, axis=0)])
    r3 = np.stack([right, right, np.roll(right, 3, axis=0)])
    fx = torch.tensor([160.0, 230.0, 190.0])
    got = tkitti.stereo_depth(torch.from_numpy(l3), torch.from_numpy(r3), fx, 0.3, max_disparity=D)
    assert got.shape == (3, *left.shape)
    for s in range(3):
        one = tkitti.stereo_depth(torch.from_numpy(l3[s]), torch.from_numpy(r3[s]), fx[s], 0.3, max_disparity=D)
        torch.testing.assert_close(got[s], one, rtol=0, atol=0)
    assert not torch.equal(got[2] > 0, got[0] > 0)
    ratio = (got[1] / got[0])[got[0] > 0]
    torch.testing.assert_close(ratio, torch.full_like(ratio, 230.0 / 160.0), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# The stereo scan
# ---------------------------------------------------------------------------

STEREO_CFG = jseq.SequentialConfig(
    alignment=JAlignmentConfig(
        min_gradient=10.0,
        solver=JSolverConfig(max_iterations=50, min_step_size=1e-7),
        include_prior=True,
        prior_weight=(FX / 525.0) ** 2,
    ),
    stereo_baseline=BASELINE,
    stereo_max_disparity=32,
    n_levels=3,
    kf_period=3,
)


def stereo_stream(n_frames=N_FRAMES, seed=0, baseline=BASELINE, trans_amp=0.05, rot_amp=0.015):
    """(poses, [(t_ns, left uint8, right uint8), ...]) of the plane scene at
    96x128, the right camera `baseline` along the left one's +x."""
    K = synthetic.camera_matrix(FX, FX, CX, CY)
    poses = synthetic.smooth_trajectory(n_frames, trans_amp=trans_amp, rot_amp=rot_amp, seed=seed)
    p0i = lie_np.inv(poses[0])
    poses = [p @ p0i for p in poses]
    items = []
    for i, p in enumerate(poses):
        il, ir, _ = _render_stereo(synthetic.render, K, baseline, (H, W), pose=p)
        items.append((i * DT_NS, np.clip(np.round(il), 0, 255).astype(np.uint8),
                      np.clip(np.round(ir), 0, 255).astype(np.uint8)))
    return poses, items


@pytest.fixture(scope="module")
def stereo():
    return stereo_stream()


def _ate(poses, results):
    gt = {i * DT_NS / 1e9: lie_np.inv(p) for i, p in enumerate(poses)}
    est = {t / 1e9: lie_np.inv(p) for t, p, _ in results}
    ate, n = metrics.ate_rmse(gt, est, max_difference=0.05)
    assert n == len(poses)
    return ate


def test_stereo_scan_matches_jax(stereo):
    poses, items = stereo
    camera = JCamera.create(FX, FX, CX, CY)
    j_results = jseq.SequentialOdometry(camera, STEREO_CFG, chunk=CHUNK).run(iter(items))
    first, chunks = jseq.stage_stream(iter(items), CHUNK)
    state = jseq.init_state(first[1], first[2], camera, STEREO_CFG)
    j_valid, j_kf = [True], [True]
    for sc in chunks:
        state, _, v, _, k = jseq.scan_odometry(state, sc.intensity, sc.depth, sc.dts, sc.live, camera, STEREO_CFG)
        j_valid += np.asarray(v)[: sc.n].tolist()
        j_kf += np.asarray(k)[: sc.n].tolist()

    cfg = interop.sequential_config_from_fields(dataclasses.asdict(STEREO_CFG))
    odo = tseq.SequentialOdometry(Camera.create(FX, FX, CX, CY, device="cpu"), cfg, chunk=CHUNK)
    t_results = odo.run(iter(items))
    assert [t for t, _, _ in t_results] == [t for t, _, _ in j_results]
    assert odo.valid == j_valid and all(odo.valid)
    assert odo.is_kf == j_kf and sum(odo.is_kf) >= 3
    for (_, Tt, ct), (_, Tj, cj) in zip(t_results, j_results):
        assert np.linalg.norm(lie_np.log(lie_np.relative(Tt, Tj))) < 1e-3
        np.testing.assert_allclose(ct, cj, rtol=1e-2, atol=1e-2 * np.abs(cj).max())
    assert _ate(poses, t_results) < 0.01


def test_stereo_first_state_uses_block_matched_depth(stereo):
    """`init_state` with a stereo config block-matches the first pair (its
    cached points sit at the stereo depth), unscaled by depth_scale."""
    _, items = stereo
    cfg = interop.sequential_config_from_fields(dataclasses.asdict(
        dataclasses.replace(STEREO_CFG, depth_scale=1.0 / 5000.0)))
    cam = Camera.create(FX, FX, CX, CY, device="cpu")
    state = tseq.init_state(items[0][1], items[0][2], cam, cfg)
    depth = tkitti.stereo_depth(torch.from_numpy(items[0][1]).float(), torch.from_numpy(items[0][2]).float(),
                                FX, BASELINE, max_disparity=32)
    z = state.kf_data[0].pcl[..., 2][state.kf_data[0].mask]
    assert z.numel() > 100
    assert 1.5 < float(z.median()) < 2.6 and float(depth[depth > 0].median()) > 1.5


# ---------------------------------------------------------------------------
# KittiDataset
# ---------------------------------------------------------------------------


def build_mini_kitti(root, seed, n_frames=N_FRAMES, baseline=0.54):
    """A KITTI odometry tree of ``n_frames`` 96x128 stereo PNG pairs (the
    layout `tests/test_cli_e2e.py:195-231` writes), calibration for fx 110
    and ``baseline``, ground truth in the KITTI pose format."""
    seq = root / "sequences" / "00"
    (seq / "image_0").mkdir(parents=True)
    (seq / "image_1").mkdir(parents=True)
    (root / "poses").mkdir()
    poses, items = stereo_stream(n_frames, seed=seed, baseline=baseline)
    rows = []
    for i, ((_, left, right), p) in enumerate(zip(items, poses)):
        Image.fromarray(left, mode="L").save(seq / "image_0" / f"{i:06d}.png")
        Image.fromarray(right, mode="L").save(seq / "image_1" / f"{i:06d}.png")
        rows.append(" ".join(f"{v:.9f}" for v in lie_np.inv(p)[:3, :4].reshape(-1)))
    (seq / "times.txt").write_text("\n".join(f"{i / 10.0:.6f}" for i in range(n_frames)) + "\n")
    (seq / "calib.txt").write_text(f"P0: {FX} 0 {CX} 0 0 {FX} {CY} 0 0 0 1 0\n"
                                   f"P1: {FX} 0 {CX} {-FX * baseline} 0 {FX} {CY} 0 0 0 1 0\n")
    (root / "poses" / "00.txt").write_text("\n".join(rows) + "\n")
    return root


@pytest.fixture(scope="module")
def mini_kitti(tmp_path_factory):
    return build_mini_kitti(tmp_path_factory.mktemp("mini_kitti"), seed=4)


def test_kitti_dataset_matches_jax(mini_kitti):
    port = tkitti.KittiDataset(str(mini_kitti), max_frames=6, max_disparity=48, device="cpu")
    ref = jkitti.KittiDataset(str(mini_kitti), max_frames=6, max_disparity=48)
    assert len(port) == len(ref) == 6
    assert port.intrinsics() == ref.intrinsics()
    assert port.baseline == pytest.approx(ref.baseline, abs=1e-12) and port.baseline == pytest.approx(0.54)
    assert port.times == ref.times
    assert sorted(port.groundtruth) == sorted(ref.groundtruth)
    for t in ref.groundtruth:
        np.testing.assert_allclose(port.groundtruth[t], ref.groundtruth[t], rtol=0, atol=1e-12)
    for (tp, lp, rp), (tj, lj, rj) in zip(port.iter_stereo(), ref.iter_stereo()):
        assert tp == tj and lp.dtype == rp.dtype == np.uint8
        np.testing.assert_array_equal(lp, lj)
        np.testing.assert_array_equal(rp, rj)
    for (tp, ip, dp), (tj, ij, dj) in zip(port, ref):
        assert tp == tj and ip.dtype == dp.dtype == np.float32
        np.testing.assert_array_equal(ip, ij)
        both = (dp > 0) & (dj > 0)
        assert both.mean() > 0.3 and ((dp > 0) != (dj > 0)).sum() <= 1e-3 * dp.size
        np.testing.assert_allclose(dp[both], dj[both], rtol=0, atol=1e-4)
