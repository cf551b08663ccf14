"""Parity of the port's robust-loss solves with the JAX package.

* The port's `gather` solve (`ic.solve_level`, sort-based median) against
  JAX `gather`, for the 7 loss x scaler cases of `test_alignment.py::
  test_fused_gn_robust_loss_matches_gather`: pose within 1e-3, valid equal.
* `solve_level_fused_plain` (the plain version of the robust CUDA kernel
  entry, bisection median) against the JAX `solve_level_fused` Pallas kernel
  in interpret mode, for 4 cases: pose within 1e-4, iterations +-1, A
  within rtol 1e-3.

One 48x64 level, one reference frame, bilinear f32, at most 512 points and
20 GN iterations (the interpret-mode kernel costs seconds per call). The
JAX results are computed once per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.alignment import ic as jic
from vslam_tpu.alignment.fused_solve import solve_level_fused as j_solve_level_fused
from vslam_tpu.core import lie_np
from vslam_tpu.core.camera import Camera as JCamera
from vslam_tpu.core.frame import create_frame as j_create_frame
from vslam_tpu.core.se3 import SE3 as JSE3
from vslam_tpu.io import synthetic
from vslam_tpu.solvers import LossConfig as JLossConfig
from vslam_tpu.solvers import SolverConfig as JSolverConfig
from vslam_tpu_torch import interop
from vslam_tpu_torch.alignment import fused_solve
from vslam_tpu_torch.alignment import ic as tic
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

H, W = 48, 64
FX = 525.0 * W / 640
XI = np.array([0.01, -0.006, 0.008, 0.003, -0.004, 0.002])
GATHER_CASES = [("Huber", "reference"), ("Tukey", "reference"), ("tdistribution", "reference"),
                ("Huber", "mad"), ("Tukey", "mad"), ("Huber", "mean"), ("Tukey", "mean")]
FUSED_CASES = [("Huber", "reference"), ("Tukey", "mad"), ("tdistribution", "reference"),
               ("Huber", "mean")]


def _cfg(function, scaler, sampler):
    return jic.AlignmentConfig(
        min_gradient=10.0,
        solver=JSolverConfig(max_iterations=20, min_step_size=1e-11, min_relative_reduction=1e-4),
        include_prior=False, interpolation="bilinear", max_points=512, sampler=sampler,
        loss=JLossConfig(function, scaler=scaler),
    )


@pytest.fixture(scope="module")
def problem():
    K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    cam = JCamera.create(FX, FX, (W - 1) / 2, (H - 1) / 2)
    ref, cur = (j_create_frame(*map(jnp.asarray, synthetic.render(K, p, (H, W))), cam, n_levels=1)
                for p in (np.eye(4), lie_np.exp(XI)))
    cam0 = JCamera(*(jnp.reshape(c, (-1,))[0] for c in ref.cameras[0]))
    data = jic.precompute_level(ref.intensity[0][None], ref.dIx[0][None], ref.dIy[0][None],
                                ref.depth[0][None], cam0, 10.0, max_points=512)
    rel0 = JSE3(jnp.eye(3)[None], jnp.zeros((1, 3)))
    return data, rel0, cur


@pytest.fixture(scope="module")
def jax_results(problem):
    """JAX results by (function, scaler, sampler), computed on first use."""
    data, rel0, cur = problem
    cache = {}

    def get(function, scaler, sampler):
        key = (function, scaler, sampler)
        if key not in cache:
            cfg = _cfg(*key)
            solve = j_solve_level_fused if sampler == "fused_gn" else jic.solve_level
            fn = lambda d, r: solve(d, r, cur.intensity[0], cur.cameras[0], cfg, None)  # noqa: E731
            cache[key] = jax.tree_util.tree_map(np.asarray, jax.jit(fn)(data, rel0))
        return cache[key]

    return get


def _torch_args(problem, function, scaler, sampler):
    data, rel0, cur = problem
    one = lambda tree: jax.tree_util.tree_map(lambda x: np.asarray(x)[None], tree)  # noqa: E731
    tcur = interop.frame_from_numpy(one(cur), device="cpu")
    cfg = interop.alignment_config_from_fields(dataclasses.asdict(_cfg(function, scaler, sampler)))
    return (interop.level_data_from_numpy(one(data), device="cpu"),
            interop.se3_from_numpy(one(rel0), device="cpu"),
            tcur.intensity[0], tcur.cameras[0], cfg, None)


def _pose(R, t):
    T = np.eye(4)
    T[:3, :3] = np.asarray(R, np.float64)
    T[:3, 3] = np.asarray(t, np.float64)
    return T


def _dist(jax_out, port_out):
    (rel_j, _), (rel_t, _) = jax_out, port_out
    return np.linalg.norm(lie_np.log(lie_np.inv(_pose(rel_j.R[0], rel_j.t[0]))
                                     @ _pose(rel_t.R[0, 0], rel_t.t[0, 0])))


@pytest.mark.parametrize("function,scaler", GATHER_CASES)
def test_gather_robust_solve_matches_jax_gather(problem, jax_results, function, scaler):
    port = tic.solve_level(*_torch_args(problem, function, scaler, "gather"))
    jax_out = jax_results(function, scaler, "gather")
    assert bool(port[1].valid[0]) == bool(jax_out[1].valid)
    assert int(jax_out[1].iterations) >= 1
    assert _dist(jax_out, port) < 1e-3
    # the solve tracks: within the reference's per-pair budget of the truth
    rel = port[0]
    assert np.linalg.norm(lie_np.log(_pose(rel.R[0, 0], rel.t[0, 0])) - XI) < 0.02


@pytest.mark.parametrize("function,scaler", FUSED_CASES)
def test_fused_plain_robust_matches_jax_kernel(problem, jax_results, function, scaler):
    port = fused_solve.solve_level_fused_plain(*_torch_args(problem, function, scaler, "fused_gn"))
    jax_out = jax_results(function, scaler, "fused_gn")
    res_t, res_j = port[1], jax_out[1]
    assert bool(res_t.valid[0]) == bool(res_j.valid)
    assert abs(int(res_t.iterations[0]) - int(res_j.iterations)) <= 1
    assert int(res_j.iterations) >= 3
    assert _dist(jax_out, port) < 1e-4
    np.testing.assert_allclose(res_t.A[0].numpy(), res_j.A, rtol=1e-3, atol=1e-6 * np.abs(res_j.A).max())
    # the first iteration sees the same residuals, scale and weights
    np.testing.assert_allclose(res_t.chi2_history[0, 0].item(), res_j.chi2_history[0], rtol=1e-4)


@pytest.mark.parametrize("function,scaler", [("Huber", "reference"), ("Tukey", "mad")])
def test_fused_robust_on_cpu_runs_the_plain_version(problem, function, scaler):
    """On CPU tensors the wrapper and `solve_level` (sampler fused_gn) run the
    plain robust version and launch nothing."""
    args = _torch_args(problem, function, scaler, "fused_gn")
    before = (fused_solve.LAUNCHES, fused_solve.ROBUST_LAUNCHES)
    outs = [fused_solve.solve_level_fused(*args), tic.solve_level(*args),
            fused_solve.solve_level_fused_plain(*args)]
    assert (fused_solve.LAUNCHES, fused_solve.ROBUST_LAUNCHES) == before
    for rel, res in outs[:2]:
        torch.testing.assert_close(rel.R, outs[2][0].R, rtol=0, atol=0)
        torch.testing.assert_close(res.A, outs[2][1].A, rtol=0, atol=0)


def test_bisection_median_brackets_the_sorted_median():
    """The kernel's 24-step bisection lands within its bracket resolution
    of the sort-based median, per (pair, frame) row, and gives 0 for an
    empty row."""
    from vslam_tpu_torch.core.image import masked_median

    rng = np.random.default_rng(5)
    r = torch.as_tensor(rng.normal(0, 20, (2, 3, 300)).astype(np.float32))
    m = torch.as_tensor(rng.random((2, 3, 300)) < 0.7)
    m[1, 2] = False
    n = m.sum(-1).float()
    got = fused_solve._bisect_median(r, m, n)
    want = masked_median(r, m)
    span = (torch.where(m, r, torch.full_like(r, -1e9)).amax(-1)
            - torch.where(m, r, torch.full_like(r, 1e9)).amin(-1))
    assert (got - want).abs().le(span * 2.0 ** -23 + 1e-6).where(n > 0, torch.tensor(True)).all()
    assert got[1, 2].item() == 0.0
