"""Parity of the port's `fused` and `mxu` samplers with the JAX package.

* Kernel 4: the plain version of `pallas_kernels.bilinear_sample_mxu`
  against the JAX `bilinear_sample_mxu_single` Pallas kernel in interpret
  mode, at points inside, on and outside the image border, negative
  coordinates included. Within 1e-4 on 0..255 intensities: both add the
  same two row products, then the same two column products (a few f32
  ulps).
* End to end at 96x128, 3 levels: `RgbdAligner.align` (two stacked
  reference frames with the motion prior, the SolverGN sink on in both
  packages for the per-level iteration counts) and `align_pairs` (B = 2)
  with `fused` (quadratic, Tukey, t-distribution; f32 and bf16 image) and
  `mxu`, against the JAX result of the same config: valid equal,
  iterations within +-1 per level (sums run in another order), pose within
  1e-3 in f32 and 2e-2 in bf16 (`test_alignment.py`'s bf16 budget). Each
  pose also meets its ground-truth budget: 0.02 for the stacked aligner
  (`test_alignment.py::test_fused_gn_stacked_with_prior_matches_gather`);
  for a pair 0.01 (`test_alignment_se3.cpp:119`), 0.02 in bf16 and with a
  robust loss, where the JAX package's own poses of these pairs miss 0.01.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.alignment import AlignmentConfig as JAlignmentConfig
from vslam_tpu.alignment import RgbdAligner as JRgbdAligner
from vslam_tpu.alignment.pallas_kernels import bilinear_sample_mxu_single as j_sample_mxu
from vslam_tpu.core import lie_np
from vslam_tpu.core.camera import Camera as JCamera
from vslam_tpu.core.frame import create_frame as j_create_frame
from vslam_tpu.core.se3 import SE3 as JSE3
from vslam_tpu.io import synthetic
from vslam_tpu.parallel.batched import align_pairs as j_align_pairs
from vslam_tpu.solvers import LossConfig as JLossConfig
from vslam_tpu.solvers import SolverConfig as JSolverConfig
from vslam_tpu.utils import log as jlog
from vslam_tpu_torch import interop
from vslam_tpu_torch.alignment import RgbdAligner as TRgbdAligner
from vslam_tpu_torch.alignment import pallas_kernels
from vslam_tpu_torch.parallel.batched import align_pairs as t_align_pairs
from vslam_tpu_torch.utils import log as tlog
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

H, W = 96, 128
FX = 525.0 * W / 640


def _mxu_points(rng, n):
    """Points spread over the image, its border rows and columns, just
    outside it and far outside, negative coordinates included."""
    inside = np.stack([rng.uniform(0, W - 1, n), rng.uniform(0, H - 1, n)], 1)
    border = np.stack([rng.choice([-1.0, -0.5, 0.0, W - 1.5, W - 1.0, W - 0.5, W], n),
                       rng.uniform(-2, H + 1, n)], 1)
    border = np.concatenate([border, border[:, ::-1] * [W / H, H / W]])
    far = rng.uniform(-3 * W, 3 * W, (n, 2))
    return np.concatenate([inside, border, far]).astype(np.float32)


def test_mxu_plain_matches_jax_kernel():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    uv = _mxu_points(rng, 1024)
    got = pallas_kernels.bilinear_sample_mxu_plain(torch.as_tensor(img)[None],
                                                   torch.as_tensor(uv[:, 0])[None],
                                                   torch.as_tensor(uv[:, 1])[None])[0].numpy()
    want = np.asarray(j_sample_mxu(jnp.asarray(img), jnp.asarray(uv[:, 0]), jnp.asarray(uv[:, 1])))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    outside = (uv[:, 0] <= -1) | (uv[:, 0] >= W) | (uv[:, 1] <= -1) | (uv[:, 1] >= H)
    assert outside.sum() > 1000 and np.all(got[outside] == 0.0)  # no clamping
    assert np.all(got[~outside] != 0.0)


def test_mxu_wrapper_forms_on_cpu():
    """The wrapper runs the plain version on CPU tensors and launches
    nothing; the unbatched form is the batched one at B = 1; images other
    than f32 are refused."""
    rng = np.random.default_rng(4)
    img = torch.as_tensor(rng.uniform(0, 255, (2, H, W)).astype(np.float32))
    uv = torch.as_tensor(_mxu_points(rng, 64).T.copy())
    u, v = uv[0].expand(2, -1).contiguous(), uv[1].expand(2, -1).contiguous()
    before = pallas_kernels.MXU_LAUNCHES
    batched = pallas_kernels.bilinear_sample_mxu(img, u, v)
    torch.testing.assert_close(batched, pallas_kernels.bilinear_sample_mxu_plain(img, u, v), rtol=0, atol=0)
    torch.testing.assert_close(pallas_kernels.bilinear_sample_mxu_single(img[1], u[1], v[1]), batched[1],
                               rtol=0, atol=0)
    assert pallas_kernels.MXU_LAUNCHES == before
    with pytest.raises(ValueError, match="float32"):
        pallas_kernels.bilinear_sample_mxu(img.to(torch.bfloat16), u, v)


@pytest.mark.parametrize("h,w,refused", [(2**16, 2**15, True), (1, 2**31 - 1, False)],
                         ids=["2^31-pixels", "2^31-1-pixels"])
def test_mxu_kernel_refuses_images_of_2_31_pixels(h, w, refused):
    """The kernel addresses a tap by its 32-bit offset in the image: its
    launcher refuses an image of 2^31 pixels or more before it builds or
    launches anything, and goes on to its device checks below that (meta
    tensors: no memory, no card)."""
    img = torch.empty(1, h, w, device="meta")
    uv = torch.empty(1, 8, device="meta")
    before = pallas_kernels.MXU_LAUNCHES
    with pytest.raises(ValueError, match=r"2\^31" if refused else "CUDA"):
        pallas_kernels.bilinear_sample_mxu(img, uv, uv)
    assert pallas_kernels.MXU_LAUNCHES == before


BASE = JAlignmentConfig(
    min_gradient=10.0,
    solver=JSolverConfig(max_iterations=30, min_step_size=1e-11, min_relative_reduction=1e-4),
    include_prior=True,
    prior_weight=(FX / 525.0) ** 2,
    interpolation="bilinear",
    max_points=2048,
)
# name: config
CONFIGS = {
    "fused-quadratic-f32": dataclasses.replace(BASE, sampler="fused"),
    "fused-quadratic-bf16": dataclasses.replace(BASE, sampler="fused", image_dtype="bfloat16"),
    "fused-tukey-f32": dataclasses.replace(BASE, sampler="fused", loss=JLossConfig("Tukey")),
    "fused-tdist-nearest-f32": dataclasses.replace(BASE, sampler="fused", interpolation="nearest",
                                                   loss=JLossConfig("tdistribution")),
    "mxu-f32": dataclasses.replace(BASE, sampler="mxu"),
}


def _pose_tol(name):
    return 2e-2 if "bf16" in name else 1e-3


def _pair_truth_budget(name):
    return 0.01 if name in ("fused-quadratic-f32", "mxu-f32") else 0.02


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pose(R, t):
    T = np.eye(4)
    T[:3, :3] = np.asarray(R, np.float64)
    T[:3, 3] = np.asarray(t, np.float64)
    return T


@pytest.fixture(scope="module")
def stacked():
    """Three frames of a short motion (keyframe, last, current)."""
    K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    cam = JCamera.create(FX, FX, (W - 1) / 2, (H - 1) / 2)
    p1 = lie_np.exp(np.array([0.008, -0.004, 0.006, 0.002, -0.003, 0.001]))
    xi12 = np.array([0.006, 0.005, -0.004, -0.002, 0.002, 0.002])
    poses = [np.eye(4), p1, lie_np.exp(xi12) @ p1]
    frames = [j_create_frame(jnp.asarray(i), jnp.asarray(d), cam, n_levels=3)
              for i, d in (synthetic.render(K, p, (H, W)) for p in poses)]
    return frames, poses, lie_np.exp(xi12) @ p1


@contextlib.contextmanager
def _solver_plots():
    """The SolverGN sink of both packages on, payloads collected."""
    got = {"jax": [], "port": []}
    sinks = {"jax": jlog.log_plt("SolverGN"), "port": tlog.log_plt("SolverGN")}
    for key, sink in sinks.items():
        sink.enabled = True
        sink.callback = (lambda k: lambda name, data: got[k].append(data))(key)
    try:
        yield got
    finally:
        for sink in sinks.values():
            sink.enabled = False
            sink.callback = None


@pytest.mark.parametrize("name", list(CONFIGS))
def test_rgbd_aligner_matches_jax(stacked, name):
    frames, poses, pred = stacked
    cfg = CONFIGS[name]
    t_frames = [interop.frame_from_numpy(_np_tree(f), device="cpu") for f in frames]
    with _solver_plots() as plots:
        pose_j, _, ok_j = JRgbdAligner(cfg).align(frames[:2], poses[:2], frames[2], pred)
        pose_t, cov_t, ok_t = TRgbdAligner(interop.alignment_config_from_fields(
            dataclasses.asdict(cfg))).align(t_frames[:2], poses[:2], t_frames[2], pred)
    assert ok_j and ok_t
    it_j, it_t = plots["jax"][0]["iterations"], plots["port"][0]["iterations"]
    assert it_t.shape == it_j.shape == (3,) and it_j.min() >= 1
    assert np.abs(it_t.astype(int) - it_j.astype(int)).max() <= 1, (it_j, it_t)
    assert plots["port"][0]["chi2"].shape == plots["jax"][0]["chi2"].shape == (3, 30)
    assert np.linalg.norm(lie_np.log(lie_np.relative(pose_t, poses[2]))) < 0.02  # ground truth
    assert np.linalg.norm(lie_np.log(lie_np.relative(pose_j, pose_t))) < _pose_tol(name)
    assert cov_t.shape == (6, 6) and np.isfinite(cov_t).all()


@pytest.fixture(scope="module")
def pairs():
    K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    cam = JCamera.create(FX, FX, (W - 1) / 2, (H - 1) / 2)
    rng = np.random.default_rng(0)
    refs, curs, xis = [], [], []
    for b in range(2):
        xi = np.concatenate([rng.uniform(-0.02, 0.02, 3), rng.uniform(-0.01, 0.01, 3)])
        scene = synthetic.default_scene(seed=b)
        for lst, pose in ((refs, np.eye(4)), (curs, lie_np.exp(xi))):
            inten, depth = synthetic.render(K, pose, (H, W), scene)
            lst.append(j_create_frame(jnp.asarray(inten), jnp.asarray(depth), cam, n_levels=3))
        xis.append(xi)
    stack = lambda fs: jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *fs)  # noqa: E731
    return stack(refs), stack(curs), xis


@pytest.mark.parametrize("name", list(CONFIGS))
def test_align_pairs_matches_jax(pairs, name):
    ref, cur, xis = pairs
    cfg = CONFIGS[name]
    B = len(xis)
    rel0 = JSE3(jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (B, 3, 3)), jnp.zeros((B, 3), jnp.float32))
    rel_j, cov_j, valid_j = _np_tree(j_align_pairs(ref, cur, rel0, None, cfg))
    rel_t, cov_t, valid_t = t_align_pairs(
        interop.frame_from_numpy(_np_tree(ref), device="cpu"),
        interop.frame_from_numpy(_np_tree(cur), device="cpu"),
        interop.se3_from_numpy(_np_tree(rel0), device="cpu"), None,
        interop.alignment_config_from_fields(dataclasses.asdict(cfg)),
    )
    np.testing.assert_array_equal(valid_t.numpy(), valid_j)
    assert valid_j.all()
    for b in range(B):
        T_t = _pose(rel_t.R[b], rel_t.t[b])
        assert np.linalg.norm(lie_np.log(lie_np.inv(_pose(rel_j.R[b], rel_j.t[b])) @ T_t)) < _pose_tol(name)
        u, _, vt = np.linalg.svd(T_t[:3, :3])
        T_t[:3, :3] = u @ vt
        assert np.linalg.norm(lie_np.log(T_t) - xis[b]) < _pair_truth_budget(name)
    assert torch.isfinite(cov_t).all()
