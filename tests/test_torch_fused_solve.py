"""Parity of the port's whole-level GN solve with the JAX package.

`solve_level_fused_plain` (the plain PyTorch version of the CUDA kernel, and
what `solve_level_fused` runs on CPU tensors) is held against the JAX
`solve_level_fused` Pallas kernel in interpret mode, and the port's
`gather` solve against the JAX `gather` solve, on the same level data
(carried over by `interop`). One 96x128 level, three problems:

* F=1, nearest, f32
* F=2 (keyframe + last frame) with the motion prior, nearest, f32
* F=1, bilinear, bf16 image

Tolerances: valid equal; iterations within +-1 (sums run in another
order); pose ||log(T_jax^-1 T_port)|| below 1e-4 in f32 and 1e-3 in bf16
(both round the bilinear row weights to bf16, but a one-ulp difference in
a warped row can move a weight across a bf16 rounding tie, see
test_torch_fused_ne.py); A within rtol 1e-3; the first iteration's chi2
within rtol 1e-4.
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
from vslam_tpu.solvers import SolverConfig as JSolverConfig
from vslam_tpu_torch import interop
from vslam_tpu_torch.alignment import fused_solve
from vslam_tpu_torch.alignment import ic as tic
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

H, W = 96, 128
FX = 525.0 * W / 640
XI01 = np.array([0.01, -0.006, 0.008, 0.003, -0.004, 0.002])
XI12 = np.array([0.008, 0.006, -0.005, -0.003, 0.002, 0.003])
P0 = np.eye(4)
P1 = lie_np.exp(XI01) @ P0
P2 = lie_np.exp(XI12) @ P1
# a prediction off the truth, so no stacked frame starts exactly at the
# identity (where points sit on the 1 < u visibility boundary)
PRED_NOISY = lie_np.exp(np.array([0.004, -0.003, 0.002, 0.001, 0.002, -0.001])) @ P2

BASE = jic.AlignmentConfig(
    min_gradient=10.0,
    solver=JSolverConfig(max_iterations=30, min_step_size=1e-11, min_relative_reduction=1e-4),
    include_prior=False,
    prior_weight=(FX / 525.0) ** 2,  # the information scale of this resolution
    interpolation="nearest",
    max_points=1024,
    sampler="fused_gn",
)
# name: (stacked reference frames, prediction, prior, config)
CASES = {
    "f1_nearest_f32": ((0,), P1, False, BASE),
    "f2_prior_nearest_f32": ((0, 1), PRED_NOISY, True, dataclasses.replace(BASE, include_prior=True)),
    "f1_bilinear_bf16": ((0,), P1, False, dataclasses.replace(
        BASE, interpolation="bilinear", image_dtype="bfloat16",
        solver=JSolverConfig(max_iterations=30, min_step_size=1e-11, min_relative_reduction=1e-2),
    )),
}


@pytest.fixture(scope="module")
def frames():
    K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    cam = JCamera.create(FX, FX, (W - 1) / 2, (H - 1) / 2)
    out = []
    for pose in (P0, P1, P2):
        inten, depth = synthetic.render(K, pose, (H, W))
        out.append(j_create_frame(jnp.asarray(inten), jnp.asarray(depth), cam, n_levels=1))
    return out


class _Problem:
    """One level's inputs in both packages (the port's with pair axis B=1)."""

    def __init__(self, frames, name, sampler):
        refs, pred, prior, cfg = CASES[name]
        self.cfg = dataclasses.replace(cfg, sampler=sampler)
        poses = [(P0, P1)[k] for k in refs]
        st = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *(frames[k] for k in refs))
        cam = JCamera(*(jnp.reshape(c, (-1,))[0] for c in st.cameras[0]))
        self.data = jic.precompute_level(st.intensity[0], st.dIx[0], st.dIy[0], st.depth[0], cam,
                                         cfg.min_gradient, max_points=cfg.max_points)
        rels = [lie_np.relative(p, pred) for p in poses]
        self.rel0 = JSE3(jnp.asarray(np.stack([r[:3, :3] for r in rels]), jnp.float32),
                         jnp.asarray(np.stack([r[:3, 3] for r in rels]), jnp.float32))
        self.x_pred = (jnp.asarray(np.stack([lie_np.log(r) for r in rels]), jnp.float32)
                       if prior else None)
        self.cur = frames[2]
        self.ref_pose = poses[0]

    def jax(self):
        cur, cfg = self.cur, self.cfg
        if cfg.sampler == "fused_gn":
            fn = lambda d, r, x: j_solve_level_fused(d, r, cur.intensity[0], cur.cameras[0], cfg, x)  # noqa: E731
        else:
            fn = lambda d, r, x: jic.solve_level(d, r, cur.intensity[0], cur.cameras[0], cfg, x)  # noqa: E731
        rel, res = jax.jit(fn)(self.data, self.rel0, self.x_pred)
        return jax.tree_util.tree_map(np.asarray, (rel, res))

    def torch_args(self):
        one = lambda tree: jax.tree_util.tree_map(lambda x: np.asarray(x)[None], tree)  # noqa: E731
        cur = interop.frame_from_numpy(one(self.cur), device="cpu")
        x_pred = None if self.x_pred is None else torch.as_tensor(np.array(self.x_pred)[None])
        return (
            interop.level_data_from_numpy(one(self.data), device="cpu"),
            interop.se3_from_numpy(one(self.rel0), device="cpu"),
            cur.intensity[0],
            cur.cameras[0],
            interop.alignment_config_from_fields(dataclasses.asdict(self.cfg)),
            x_pred,
        )


def _pose(R, t):
    T = np.eye(4)
    T[:3, :3] = np.asarray(R, np.float64)
    T[:3, 3] = np.asarray(t, np.float64)
    return T


def _assert_parity(name, jax_out, port_out):
    (rel_j, res_j), (rel_t, res_t) = jax_out, port_out
    assert bool(res_t.valid[0]) == bool(res_j.valid)
    it_j, it_t = int(res_j.iterations), int(res_t.iterations[0])
    assert abs(it_j - it_t) <= 1, (it_j, it_t)
    assert it_j >= 5, f"{name}: a parity problem should take several iterations"
    d = np.linalg.norm(lie_np.log(lie_np.inv(_pose(rel_j.R[0], rel_j.t[0]))
                                  @ _pose(rel_t.R[0, 0], rel_t.t[0, 0])))
    assert d < (1e-3 if "bf16" in name else 1e-4), d
    A_j = res_j.A
    np.testing.assert_allclose(res_t.A[0].numpy(), A_j, rtol=1e-3, atol=1e-6 * np.abs(A_j).max())
    # the first evaluated iteration sees the same state in both packages
    np.testing.assert_allclose(res_t.chi2_history[0, 0].item(), res_j.chi2_history[0], rtol=1e-4)


@pytest.mark.parametrize("name", list(CASES))
def test_fused_plain_matches_jax_kernel(frames, name):
    problem = _Problem(frames, name, "fused_gn")
    port = fused_solve.solve_level_fused_plain(*problem.torch_args())
    _assert_parity(name, problem.jax(), port)
    # history: evaluated iterations recorded, NaN after
    n_eval = int(np.isfinite(port[1].chi2_history[0].numpy()).sum())
    assert n_eval >= int(port[1].iterations[0])
    assert torch.isnan(port[1].step_history[0, n_eval:]).all()


@pytest.mark.parametrize("name", ["f1_nearest_f32", "f2_prior_nearest_f32"])
def test_gather_solve_matches_jax_gather(frames, name):
    problem = _Problem(frames, name, "gather")
    _assert_parity(name, problem.jax(), tic.solve_level(*problem.torch_args()))


@pytest.mark.parametrize("name", list(CASES))
def test_solve_level_fused_on_cpu_runs_the_plain_version(frames, name):
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; `solve_level` with sampler fused_gn routes there too."""
    args = _Problem(frames, name, "fused_gn").torch_args()
    before = fused_solve.LAUNCHES
    rel_w, res_w = fused_solve.solve_level_fused(*args)
    rel_s, res_s = tic.solve_level(*args)
    rel_p, res_p = fused_solve.solve_level_fused_plain(*args)
    assert fused_solve.LAUNCHES == before
    for a, b in ((rel_w, rel_p), (rel_s, rel_p), (res_w.A, res_p.A), (res_s.iterations, res_p.iterations)):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_plain_batch_equals_single_pairs(frames):
    """Pairs in one batch do not interact: each pair's result equals its
    result solved alone (per-pair early exit)."""
    pa = _Problem(frames, "f1_nearest_f32", "fused_gn").torch_args()
    pb = _Problem(frames, "f1_bilinear_bf16", "fused_gn").torch_args()
    cfg = pa[4]
    rel0_b = type(pa[1])(*(x.clone() for x in pa[1]))
    rel0_b.t[0, 0, 0] += 0.004  # a different start for the second pair
    cat = lambda *xs: torch.cat(xs)  # noqa: E731
    data = type(pa[0])(*(cat(a, b) for a, b in zip(pa[0], pb[0])))
    rel0 = type(pa[1])(*(cat(a, b) for a, b in zip(pa[1], rel0_b)))
    cam = type(pa[3])(*(cat(a, b) for a, b in zip(pa[3], pb[3])))
    _, both = fused_solve.solve_level_fused_plain(data, rel0, cat(pa[2], pb[2]), cam, cfg, None)
    _, first = fused_solve.solve_level_fused_plain(pa[0], pa[1], pa[2], pa[3], cfg, None)
    _, second = fused_solve.solve_level_fused_plain(pb[0], rel0_b, pb[2], pb[3], cfg, None)
    assert both.iterations.tolist() == [int(first.iterations[0]), int(second.iterations[0])]
    assert both.iterations[0] != both.iterations[1]
    torch.testing.assert_close(both.A, torch.cat([first.A, second.A]), rtol=1e-6, atol=1e-6)
