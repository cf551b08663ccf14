"""Pose-graph optimization over SE(3) relative-pose constraints.

Port of `vslam_tpu.ba.pose_graph` (the keyframe graph behind loop closure;
the reference stops at windowed BA). Node poses T_i (world->cam), edges
with measured relatives Z_ij ~ T_j . T_i^-1 and 6x6 information; residual
r_e = log(Z_ij^-1 . T_j . T_i^-1). On-manifold LM: each iteration
relinearizes, solves for per-node tangent steps and retracts T <- exp(d) .
T; node 0 is the gauge anchor, padding nodes are frozen, padding edges
masked.

- Per-edge 6x12 Jacobian blocks in closed form (the SE(3) inverse left
  Jacobian at the edge's residual, in f64), held to the JAX package's
  vmap(jacfwd) by the tests.
- Two linear solvers: ``dense`` assembles the (6K, 6K) Hessian and solves
  it exactly; ``pcg`` is matrix-free block-Jacobi preconditioned conjugate
  gradients (edge-wise Hessian-vector products, the inverse damped 6x6
  diagonal blocks as preconditioner), O(E) per iteration. ``auto`` takes
  pcg above `_DENSE_MAX_NODES`.

The LM and CG loops are host loops that read one scalar per iteration (the
JAX package's `lax.while_loop`s). Everything runs on the device of the
graph's tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core import se3
from ..core.se3 import SE3

__all__ = ["PoseGraph", "optimize_pose_graph", "pad_pose_graph"]


class PoseGraph(NamedTuple):
    poses: SE3  # (K,) initial node poses (world->cam)
    edge_i: torch.Tensor  # (E,) int64 source node
    edge_j: torch.Tensor  # (E,) int64 target node
    edge_rel: SE3  # (E,) measured T_j . T_i^-1
    edge_info: torch.Tensor  # (E, 6, 6) information matrices
    edge_mask: torch.Tensor  # (E,) bool


def pad_pose_graph(g: PoseGraph, n_nodes: int, n_edges: int) -> Tuple[PoseGraph, torch.Tensor]:
    """Pad to n_nodes / n_edges. Returns (padded graph, node_mask (n_nodes,)):
    padding nodes are identity poses (frozen by the mask), padding edges
    self-loops on node 0 with mask False."""
    K = g.poses.t.shape[0]
    E = g.edge_i.shape[0]
    assert n_nodes >= K and n_edges >= E, (K, E, n_nodes, n_edges)
    dtype, dev = g.poses.t.dtype, g.poses.t.device
    pk, pe = n_nodes - K, n_edges - E

    def pad_se3(x: SE3, n: int) -> SE3:
        eyeR = torch.eye(3, dtype=dtype, device=dev).expand(n, 3, 3)
        return SE3(torch.cat([x.R, eyeR]), torch.cat([x.t, torch.zeros(n, 3, dtype=dtype, device=dev)]))

    zeros_i = torch.zeros(pe, dtype=g.edge_i.dtype, device=dev)
    padded = PoseGraph(
        poses=pad_se3(g.poses, pk),
        edge_i=torch.cat([g.edge_i, zeros_i]),
        edge_j=torch.cat([g.edge_j, zeros_i]),
        edge_rel=pad_se3(g.edge_rel, pe),
        edge_info=torch.cat([g.edge_info, torch.eye(6, dtype=dtype, device=dev).expand(pe, 6, 6)]),
        edge_mask=torch.cat([g.edge_mask, torch.zeros(pe, dtype=torch.bool, device=dev)]),
    )
    return padded, torch.arange(n_nodes, device=dev) < K


def _edge_res(di, dj, Ti: SE3, Tj: SE3, Z: SE3) -> torch.Tensor:
    """r_e at tangent steps (di, dj) around (Ti, Tj), every edge at once: (E, 6)."""
    Ti_n = se3.compose(se3.exp(di), Ti)
    Tj_n = se3.compose(se3.exp(dj), Tj)
    return se3.log(se3.compose(se3.inverse(Z), se3.compose(Tj_n, se3.inverse(Ti_n))))


def _left_jacobian_inv(xi: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SE(3) at xi (..., 6) = [rho; phi] (Barfoot,
    State Estimation for Robotics, eqs. 7.86 and 7.95): [[J^-1, -J^-1 Q
    J^-1], [0, J^-1]], J the SO(3) left Jacobian. Series below 1e-3 rad."""
    rho, phi = xi[..., :3], xi[..., 3:]
    th2 = (phi * phi).sum(-1)
    th = torch.sqrt(th2)
    small = th < 1e-3
    ths = torch.where(small, torch.ones_like(th), th)
    s, c = torch.sin(ths), torch.cos(ths)
    c1 = torch.where(small, 1 / 6 - th2 / 120, (ths - s) / ths**3)
    c2 = torch.where(small, 1 / 24 - th2 / 720, (ths**2 + 2 * c - 2) / (2 * ths**4))
    c3 = torch.where(small, 1 / 120 - th2 / 2520, (2 * ths - 3 * s + ths * c) / (2 * ths**5))
    cot = torch.where(small, 1 / 12 + th2 / 720, 1 / ths**2 - (1 + c) / (2 * ths * s))
    P, Rh = se3.so3_hat(phi), se3.so3_hat(rho)
    PR, RP, PP = P @ Rh, Rh @ P, P @ P
    PRP = PR @ P
    k = lambda a: a[..., None, None]  # noqa: E731
    Q = 0.5 * Rh + k(c1) * (PR + RP + PRP) + k(c2) * (PP @ Rh + RP @ P - 3 * PRP) + k(c3) * (PRP @ P + PP @ Rh @ P)
    Ji = torch.eye(3, dtype=xi.dtype, device=xi.device) - 0.5 * P + k(cot) * PP
    return torch.cat([torch.cat([Ji, -Ji @ Q @ Ji], -1), torch.cat([torch.zeros_like(Ji), Ji], -1)], -2)


def _edge_jac(Ti: SE3, Tj: SE3, Z: SE3):
    """d r / d di and d r / d dj of every edge at zero steps, (E, 6, 6)
    each, in closed form (the JAX package differentiates forward mode):
    with E0 = Z^-1 Tj Ti^-1 and r0 = log(E0), the steps enter as
    exp(Ad(Z^-1) dj) E0 exp(-di), so d r / d dj = Jl^-1(r0) Ad(Z^-1) and
    d r / d di = -Jr^-1(r0) = -Jl^-1(-r0). Evaluated in f64."""
    dtype = Ti.R.dtype
    f64 = lambda T: SE3(T.R.double(), T.t.double())  # noqa: E731
    Ti, Tj, Z = f64(Ti), f64(Tj), f64(Z)
    Zi = se3.inverse(Z)
    r0 = se3.log(se3.compose(Zi, se3.compose(Tj, se3.inverse(Ti))))
    return (-_left_jacobian_inv(-r0)).to(dtype), (_left_jacobian_inv(r0) @ se3.adjoint(Zi)).to(dtype)


# above this many nodes, solver="auto" takes the matrix-free PCG: the dense
# system holds K^2 * 36 floats and its factorization costs (6K)^3 / 3
_DENSE_MAX_NODES = 768


def _pcg(matvec, minv, b, max_cg: int, rtol: float):
    """Preconditioned CG on the (K, 6) tangent layout: stops at ||r|| <= rtol
    ||b|| or after max_cg iterations. Returns (x, iterations)."""
    b2 = torch.sum(b * b)
    x = torch.zeros_like(b)
    r = b
    z = minv(r)
    p = z
    rz = torch.sum(r * z)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    i = 0
    while i < max_cg and bool(torch.sum(r * r) > rtol * rtol * b2):
        Ap = matvec(p)
        pAp = torch.sum(p * Ap)
        alpha = torch.where(pAp > 0, rz / torch.where(pAp > 0, pAp, one), zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = minv(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.where(rz != 0, rz, one)
        p = z + beta * p
        rz = rz_new
        i += 1
    return x, i


def optimize_pose_graph(g: PoseGraph, max_iterations: int = 30, lambda0: float = 1e-4,
                        node_mask: Optional[torch.Tensor] = None, solver: str = "auto", max_cg: int = 256,
                        cg_rtol: float = 1e-6) -> Tuple[SE3, torch.Tensor, torch.Tensor]:
    """On-manifold LM. Returns (poses, chi2_before, chi2_after).
    ``node_mask`` marks the live nodes; ``solver`` is "dense", "pcg" or
    "auto". `optimize_pose_graph.cg_iterations` holds the CG iterations of
    the last call (0 for the dense solve)."""
    K = g.poses.t.shape[0]
    E = g.edge_i.shape[0]
    dtype, dev = g.poses.t.dtype, g.poses.t.device
    if solver == "auto":
        solver = "pcg" if K > _DENSE_MAX_NODES else "dense"
    kk = torch.arange(K, device=dev)
    free = (kk > 0) if node_mask is None else ((kk > 0) & node_mask)
    free6 = torch.repeat_interleave(free, 6)
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    # edge weights by the information's Cholesky factor: whitened r = L^T r
    Lt = torch.linalg.cholesky(g.edge_info + 1e-9 * eye6).transpose(-1, -2)
    wmask = g.edge_mask[:, None].to(dtype)
    ei, ej = g.edge_i, g.edge_j
    z6 = torch.zeros(E, 6, dtype=dtype, device=dev)

    def gather(T: SE3, idx) -> SE3:
        return SE3(T.R[idx], T.t[idx])

    def chi2_of(T: SE3) -> torch.Tensor:
        r = _edge_res(z6, z6, gather(T, ei), gather(T, ej), g.edge_rel)
        rw = torch.einsum("eab,eb->ea", Lt, r) * wmask
        return torch.sum(rw * rw)

    def edge_terms(T: SE3):
        """Whitened residuals rw (E, 6) and Jacobian blocks Jiw, Jjw (E, 6, 6)."""
        Ti, Tj = gather(T, ei), gather(T, ej)
        r = _edge_res(z6, z6, Ti, Tj, g.edge_rel)
        Ji, Jj = _edge_jac(Ti, Tj, g.edge_rel)
        rw = torch.einsum("eab,eb->ea", Lt, r) * wmask
        Jiw = torch.einsum("eab,ebc->eac", Lt, Ji) * wmask[:, :, None]
        Jjw = torch.einsum("eab,ebc->eac", Lt, Jj) * wmask[:, :, None]
        return rw, Jiw, Jjw

    def bt(A, B):  # A^T B per edge
        return torch.einsum("eba,ebc->eac", A, B)

    def seg(vals, idx):
        return torch.zeros((K,) + vals.shape[1:], dtype=dtype, device=dev).index_add_(0, idx, vals)

    def solve_dense(rw, Jiw, Jjw, lam):
        """Assemble the (6K, 6K) Hessian and solve exactly."""
        H4 = torch.zeros(K, K, 6, 6, dtype=dtype, device=dev)
        H4.index_put_((ei, ei), bt(Jiw, Jiw), accumulate=True)
        H4.index_put_((ei, ej), bt(Jiw, Jjw), accumulate=True)
        H4.index_put_((ej, ei), bt(Jjw, Jiw), accumulate=True)
        H4.index_put_((ej, ej), bt(Jjw, Jjw), accumulate=True)
        b = seg(torch.einsum("eba,eb->ea", Jiw, rw), ei) + seg(torch.einsum("eba,eb->ea", Jjw, rw), ej)
        H = H4.permute(0, 2, 1, 3).reshape(K * 6, K * 6)
        b = b.reshape(K * 6)
        # the gauge and frozen nodes: identity rows and columns
        H = torch.where(free6[:, None] & free6[None, :], H, torch.zeros_like(H))
        H = H + torch.diag(torch.where(free6, lam, torch.ones_like(lam)))
        b = torch.where(free6, b, torch.zeros_like(b))
        return torch.linalg.solve(H, b).reshape(K, 6)

    def solve_pcg(rw, Jiw, Jjw, lam):
        """Matrix-free block-Jacobi PCG on the same damped, gauged system."""
        fm = free[:, None].to(dtype)
        b = (seg(torch.einsum("eba,eb->ea", Jiw, rw), ei) + seg(torch.einsum("eba,eb->ea", Jjw, rw), ej)) * fm
        D = seg(bt(Jiw, Jiw), ei) + seg(bt(Jjw, Jjw), ej)
        D = D * fm[:, :, None] * fm[:, None, :]
        D = torch.where(free[:, None, None], D + lam * eye6, eye6)
        Dinv = torch.linalg.inv(D)
        JiT, JjT = Jiw.transpose(1, 2), Jjw.transpose(1, 2)

        def matvec(v):  # identity on frozen rows, H + lam I on free ones
            vf = v * fm
            u = Jiw @ vf[ei].unsqueeze(-1) + Jjw @ vf[ej].unsqueeze(-1)  # (E, 6, 1)
            y = seg((JiT @ u).squeeze(-1), ei) + seg((JjT @ u).squeeze(-1), ej)
            return (y + lam * vf) * fm + (v - vf)

        x, iterations = _pcg(matvec, lambda r: (Dinv @ r.unsqueeze(-1)).squeeze(-1), b, max_cg=max_cg, rtol=cg_rtol)
        nonlocal cg_total
        cg_total += iterations
        return x

    T = g.poses
    c0 = chi2_of(T)
    c_prev = c0
    lam = torch.tensor(lambda0, dtype=dtype, device=dev)
    cg_total = 0
    it = 0
    done = False
    while not done and it < max_iterations:
        rw, Jiw, Jjw = edge_terms(T)
        dx = (solve_pcg if solver == "pcg" else solve_dense)(rw, Jiw, Jjw, lam)
        T_new = se3.compose(se3.exp(-dx), T)
        c_new = chi2_of(T_new)
        accept = (c_new < c_prev) & torch.isfinite(c_new)
        T = SE3(torch.where(accept, T_new.R, T.R), torch.where(accept, T_new.t, T.t))
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-9), torch.clamp(lam * 5.0, max=1e8))
        c_prev = torch.where(accept, c_new, c_prev)
        it += 1
        done = bool((accept & (torch.linalg.vector_norm(dx) < 1e-8)) | (lam >= 1e8))  # the one read
    optimize_pose_graph.cg_iterations = cg_total
    return se3.orthonormalize(T), c0, c_prev


optimize_pose_graph.cg_iterations = 0
