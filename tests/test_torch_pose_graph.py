"""The port's pose-graph optimizer (`vslam_tpu_torch.ba.pose_graph`)
against the JAX package's, on `tests/test_pose_graph.py`'s graphs: a loop
of K poses with noisy odometry edges and one exact closure (seeded numpy),
and a chain with several loop edges.

Tolerances (f32 in both; LM accepts a step on one chi2 comparison, so
final states are compared):
* the per-edge residuals within 1e-6 and the closed-form 6x6 Jacobian
  blocks within 1e-5 of JAX's vmap(jacfwd), at the loop's initial state and
  at a state whose residuals reach ~0.5 rad;
* dense and PCG solves: initial chi2 within rtol 1e-5, final chi2 within
  rtol 1e-2 (atol 1e-6), node translations within 1e-4 (dense) and 5e-4
  (PCG, an inexact inner solve);
* the padded graph: `pad_pose_graph` leaves equal to JAX's, and the padded
  solve within 1e-4 of the unpadded one (frozen nodes, masked edges);
* PCG against the dense solve on the port alone, as
  `test_pcg_matches_dense`: initial chi2 within rtol 1e-5, PCG's final
  chi2 below 0.1 of its initial, translations within 5e-3;
* the five-loop chain at 900 nodes (the card's phase 26 graph) by PCG at
  the JAX test's cap (512) and at solver "auto"'s (256): initial chi2
  within rtol 1e-5, final chi2 within rtol 1e-3 of JAX's. Both stall far
  above the dense optimum (chi2 ~54 and ~511 against 0.003): the cap, not
  the port, stops them. Their translations are not compared: the stalled
  solutions lie tens of metres from the optimum along the chain's soft
  bending, and 0.1-0.2 m from each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.ba import pose_graph as jpg
from vslam_tpu.core.se3 import SE3 as JSE3
from vslam_tpu_torch import interop
from vslam_tpu_torch.ba import pose_graph as tpg
from vslam_tpu_torch.core import lie_np
from vslam_tpu_torch.core.se3 import SE3

from test_pose_graph import build_loop
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)


def chain_with_loops(K=48, seed=7):
    """A noisy chain of K poses with five exact loop edges (the shape of
    `test_pcg_large_chain_with_loops`), as a JAX PoseGraph."""
    rng = np.random.default_rng(seed)
    poses_gt = [np.eye(4)]
    step = np.array([0.4, 0.0, 0.05, 0.0, 2 * np.pi / K, 0.0])
    for _ in range(1, K):
        poses_gt.append(lie_np.exp(step) @ poses_gt[-1])
    edges = []
    for k in range(K - 1):
        edges.append((k, k + 1, lie_np.exp(rng.normal(0, 0.01, 6)) @ lie_np.relative(poses_gt[k], poses_gt[k + 1]),
                      1.0))
    for a, b in [(K - 1, 0), (K // 2, 0), (3 * K // 4, K // 4), (K - 1, K // 2), (K // 3, 0)]:
        edges.append((a, b, lie_np.relative(poses_gt[a], poses_gt[b]), 100.0))
    init = [np.eye(4)]
    for k in range(K - 1):
        init.append(edges[k][2] @ init[-1])
    f32 = lambda a: jnp.asarray(np.asarray(a), jnp.float32)  # noqa: E731
    return jpg.PoseGraph(
        poses=JSE3(f32([T[:3, :3] for T in init]), f32([T[:3, 3] for T in init])),
        edge_i=jnp.asarray([e[0] for e in edges], jnp.int32), edge_j=jnp.asarray([e[1] for e in edges], jnp.int32),
        edge_rel=JSE3(f32([e[2][:3, :3] for e in edges]), f32([e[2][:3, 3] for e in edges])),
        edge_info=f32([np.eye(6) * e[3] for e in edges]), edge_mask=jnp.ones(len(edges), bool))


def _T(R, t):
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = np.asarray(R, np.float64), np.asarray(t, np.float64)
    return T


@pytest.fixture(scope="module")
def loop():
    return build_loop(np.random.default_rng(42), K=16)[0]


def _port(g):
    return interop.pose_graph_from_numpy(g, device="cpu")


@pytest.mark.parametrize("noise", [0.0, 0.2])
def test_edge_residuals_and_jacobians_match_jax(loop, noise):
    g = loop
    if noise:
        dT = lie_np.exp  # node poses moved by a seeded random twist each
        moved = [dT(np.random.default_rng(k).normal(0, noise, 6)) @ _T(g.poses.R[k], g.poses.t[k])
                 for k in range(g.poses.t.shape[0])]
        g = g._replace(poses=JSE3(jnp.asarray(np.stack([T[:3, :3] for T in moved]), jnp.float32),
                                  jnp.asarray(np.stack([T[:3, 3] for T in moved]), jnp.float32)))
    Ti = jax.tree_util.tree_map(lambda x: x[g.edge_i], g.poses)
    Tj = jax.tree_util.tree_map(lambda x: x[g.edge_j], g.poses)
    z = jnp.zeros((g.edge_i.shape[0], 6))
    Ji, Jj = jpg._edge_jac(z, z, Ti, Tj, g.edge_rel)
    r = jpg._edge_res(z, z, Ti, Tj, g.edge_rel)
    tg = _port(g)
    tTi = SE3(tg.poses.R[tg.edge_i], tg.poses.t[tg.edge_i])
    tTj = SE3(tg.poses.R[tg.edge_j], tg.poses.t[tg.edge_j])
    z6 = torch.zeros(tg.edge_i.shape[0], 6)
    tJi, tJj = tpg._edge_jac(tTi, tTj, tg.edge_rel)
    np.testing.assert_allclose(tpg._edge_res(z6, z6, tTi, tTj, tg.edge_rel).numpy(), np.asarray(r), atol=1e-6)
    np.testing.assert_allclose(tJi.numpy(), np.asarray(Ji), atol=1e-5)
    np.testing.assert_allclose(tJj.numpy(), np.asarray(Jj), atol=1e-5)


@pytest.mark.parametrize("graph,solver", [("loop", "dense"), ("loop", "pcg"), ("chain", "dense"), ("chain", "pcg")])
def test_optimize_matches_jax(loop, graph, solver):
    g = loop if graph == "loop" else chain_with_loops()
    kw = dict(max_iterations=30, solver=solver)
    if solver == "pcg":
        kw.update(max_cg=256, cg_rtol=1e-8)
    jo, jc0, jc1 = jpg.optimize_pose_graph(g, **kw)
    to, tc0, tc1 = tpg.optimize_pose_graph(_port(g), **kw)
    np.testing.assert_allclose(float(tc0), float(jc0), rtol=1e-5)
    np.testing.assert_allclose(float(tc1), float(jc1), rtol=1e-2, atol=1e-6)
    assert float(tc1) < 0.1 * float(tc0)
    np.testing.assert_allclose(to.t.numpy(), np.asarray(jo.t), atol=1e-4 if solver == "dense" else 5e-4)
    if solver == "pcg":
        assert tpg.optimize_pose_graph.cg_iterations > 0


def test_padded_graph_matches_jax_and_unpadded(loop):
    jgp, jmask = jpg.pad_pose_graph(loop, 32, 32)
    tgp, tmask = tpg.pad_pose_graph(_port(loop), 32, 32)
    for got, want in zip(jax.tree_util.tree_leaves(tuple(tgp)), jax.tree_util.tree_leaves(tuple(jgp))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    to, tc0, _ = tpg.optimize_pose_graph(_port(loop))
    tpo, tpc0, _ = tpg.optimize_pose_graph(tgp, node_mask=tmask)
    np.testing.assert_allclose(float(tpc0), float(tc0), rtol=1e-5)
    np.testing.assert_allclose(tpo.t.numpy()[:16], to.t.numpy(), atol=1e-4)
    np.testing.assert_array_equal(tpo.t.numpy()[16:], 0.0)


def test_pcg_matches_dense_on_the_port():
    g = _port(chain_with_loops(K=64, seed=3))
    od, cd0, cd1 = tpg.optimize_pose_graph(g, solver="dense")
    op, cp0, cp1 = tpg.optimize_pose_graph(g, solver="pcg", max_cg=256, cg_rtol=1e-8)
    np.testing.assert_allclose(float(cp0), float(cd0), rtol=1e-5)
    assert float(cp1) < 0.1 * float(cp0)
    np.testing.assert_allclose(op.t.numpy(), od.t.numpy(), atol=5e-3)


@pytest.mark.parametrize("max_cg", [512, 256])
def test_pcg_at_900_nodes_matches_jax(max_cg):
    g = chain_with_loops(K=900, seed=7)
    _, jc0, jc1 = jpg.optimize_pose_graph(g, solver="pcg", max_cg=max_cg, cg_rtol=1e-8)
    _, tc0, tc1 = tpg.optimize_pose_graph(_port(g), solver="pcg", max_cg=max_cg, cg_rtol=1e-8)
    np.testing.assert_allclose(float(tc0), float(jc0), rtol=1e-5)
    np.testing.assert_allclose(float(tc1), float(jc1), rtol=1e-3)
