"""Parity of the port's visual-log path with the JAX package.

* `SolverResult.x_history`: `ic.solve_level(record_iterations=True)` of
  both packages on one 96x128 level (gather sampler, f32): the same count
  of evaluated iterations (+-1, sums run in another order), log(delta)
  within 1e-4 at the common ones, NaN after.
* `RgbdAligner.align` with the ImageWarped / Residual / Weights sinks and
  SolverGN on, at 48x64 over 2 levels (`test_observability.py:163-230`),
  in two configs: the quadratic gather default, and the production robust
  profile (`fused_gn`, Huber, bilinear, bf16), whose record path runs the
  per-iteration loop through `fused_level_sample`. The same number of
  images per level, (F, H_l, W_l) each; the same SolverGN payload shapes;
  the coarsest level's residual falling by >= 10 % from its first image to
  its last; and the images of the first iteration of each level, where both
  packages replay the same state, equal within 1e-3 in f32 (0.6 in bf16
  mode at the rare pixels where a bf16 rounding tie moves the solve's
  state by an ulp; see test_torch_fused_ne.py) over the pixels both
  packages log.
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
from vslam_tpu.alignment import ic as jic
from vslam_tpu.core import lie_np
from vslam_tpu.core.camera import Camera as JCamera
from vslam_tpu.core.frame import create_frame as j_create_frame
from vslam_tpu.core.se3 import SE3 as JSE3
from vslam_tpu.io import synthetic
from vslam_tpu.solvers import LossConfig as JLossConfig
from vslam_tpu.solvers import SolverConfig as JSolverConfig
from vslam_tpu.utils import log as jlog
from vslam_tpu_torch import interop
from vslam_tpu_torch.alignment import RgbdAligner as TRgbdAligner
from vslam_tpu_torch.alignment import ic as tic
from vslam_tpu_torch.utils import log as tlog
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

SINKS = ("ImageWarped", "Residual", "Weights")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_x_history_matches_jax_encode_x():
    H, W = 96, 128
    fx = 525.0 * W / 640
    K = synthetic.camera_matrix(fx, fx, (W - 1) / 2, (H - 1) / 2)
    cam = JCamera.create(fx, fx, (W - 1) / 2, (H - 1) / 2)
    xi = np.array([0.01, -0.006, 0.008, 0.003, -0.004, 0.002])
    f0, f1 = (j_create_frame(jnp.asarray(i), jnp.asarray(d), cam, n_levels=1)
              for i, d in (synthetic.render(K, p, (H, W)) for p in (np.eye(4), lie_np.exp(xi))))
    cfg = JAlignmentConfig(min_gradient=10.0, include_prior=False, max_points=1024,
                           solver=JSolverConfig(max_iterations=30, min_step_size=1e-11,
                                                min_relative_reduction=1e-4))
    data = jax.tree_util.tree_map(lambda x: x[None], jic.precompute_level(
        f0.intensity[0], f0.dIx[0], f0.dIy[0], f0.depth[0], cam, cfg.min_gradient, max_points=1024))
    rel0 = JSE3(jnp.eye(3, dtype=jnp.float32)[None], jnp.zeros((1, 3), jnp.float32))
    _, res_j = jic.solve_level(data, rel0, f1.intensity[0], cam, cfg, None, record_iterations=True)
    one = lambda tree: jax.tree_util.tree_map(lambda x: np.asarray(x)[None], tree)  # noqa: E731
    cur = interop.frame_from_numpy(one(f1), device="cpu")
    _, res_t = tic.solve_level(interop.level_data_from_numpy(one(data), device="cpu"),
                               interop.se3_from_numpy(one(rel0), device="cpu"),
                               cur.intensity[0], cur.cameras[0],
                               interop.alignment_config_from_fields(dataclasses.asdict(cfg)), None,
                               record_iterations=True)
    x_j, x_t = np.asarray(res_j.x_history), res_t.x_history[0].numpy()
    assert x_t.shape == x_j.shape == (30, 6)
    n_j, n_t = int(np.isfinite(x_j[:, 0]).sum()), int(np.isfinite(x_t[:, 0]).sum())
    assert n_j >= 5 and abs(n_j - n_t) <= 1
    assert np.isnan(x_t[n_t:]).all() and np.isfinite(x_t[:n_t]).all()
    np.testing.assert_array_equal(x_t[0], np.zeros(6, np.float32))  # the level starts at delta = I
    n = min(n_j, n_t)
    np.testing.assert_allclose(x_t[:n], x_j[:n], rtol=0, atol=1e-4)


@contextlib.contextmanager
def _sinks_on(tmp_path):
    """Every sink of both packages on, arrays collected in memory."""
    got = {"jax": {n: [] for n in SINKS + ("SolverGN",)}, "port": {n: [] for n in SINKS + ("SolverGN",)}}
    sinks = []
    for key, mod in (("jax", jlog), ("port", tlog)):
        for n in SINKS + ("SolverGN",):
            sink = mod.log_plt(n) if n == "SolverGN" else mod.log_img(n)
            sink.enabled = True
            sink.callback = (lambda k, nn: lambda name, arr: got[k][nn].append(arr))(key, n)
            sinks.append(sink)
    try:
        yield got
    finally:
        for sink in sinks:
            sink.enabled = False
            sink.callback = None


H, W, FX = 48, 64, 55.0
BASE = JAlignmentConfig(min_gradient=5.0, solver=JSolverConfig(max_iterations=10, min_step_size=1e-7),
                        include_prior=False, prior_weight=0.0)
CONFIGS = {
    "gather-quadratic": BASE,
    "fused_gn-huber-bf16": dataclasses.replace(BASE, sampler="fused_gn", loss=JLossConfig("Huber"),
                                               image_dtype="bfloat16"),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_visual_log_matches_jax(tmp_path, name):
    K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    cam = JCamera.create(FX, FX, (W - 1) / 2, (H - 1) / 2)
    frames = [j_create_frame(jnp.asarray(i), jnp.asarray(d), cam, n_levels=2)
              for i, d in (synthetic.render(K, p, (H, W)) for p in
                           (np.eye(4), lie_np.exp(np.array([0.05, 0, 0, 0, 0.02, 0]))))]
    t_frames = [interop.frame_from_numpy(_np_tree(f), device="cpu") for f in frames]
    cfg = CONFIGS[name]
    with _sinks_on(tmp_path) as got:
        _, _, ok_j = JRgbdAligner(cfg).align(frames[:1], [np.eye(4)], frames[1], np.eye(4))
        _, _, ok_t = TRgbdAligner(interop.alignment_config_from_fields(dataclasses.asdict(cfg))).align(
            t_frames[:1], [np.eye(4)], t_frames[1], np.eye(4))
    assert ok_j and ok_t
    (plot_j,), (plot_t,) = got["jax"]["SolverGN"], got["port"]["SolverGN"]
    assert {k: v.shape for k, v in plot_t.items()} == {k: v.shape for k, v in plot_j.items()}
    assert plot_t["chi2"].shape == (2, 10)
    for sink in SINKS:
        imgs_j, imgs_t = got["jax"][sink], got["port"][sink]
        shapes = [a.shape for a in imgs_t]
        assert shapes == [a.shape for a in imgs_j], sink  # one image per evaluated iteration
        assert set(shapes) == {(1, H // 2, W // 2), (1, H, W)}
        # coarsest level first; its iteration count is the payload's
        n_coarse = int(np.isfinite(plot_t["chi2"][0]).sum())
        assert shapes[:n_coarse] == [(1, H // 2, W // 2)] * n_coarse
        for first in (0, n_coarse):  # each level's first iteration
            a_t, a_j = imgs_t[first], imgs_j[first]
            both = (a_t != 0) & (a_j != 0)
            assert both.mean() > 0.05
            tol = 0.6 if "bf16" in name else 1e-3
            np.testing.assert_allclose(a_t[both], a_j[both], rtol=0, atol=tol)

    def mean_abs(a):
        nz = np.abs(a[0])
        return nz[nz > 0].mean()

    coarse = [a for a in got["port"]["Residual"] if a.shape == (1, H // 2, W // 2)]
    assert len(coarse) >= 2 and mean_abs(coarse[-1]) <= 0.9 * mean_abs(coarse[0])
