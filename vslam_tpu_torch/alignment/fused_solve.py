"""Whole-level Gauss-Newton solve as one CUDA kernel per pyramid level.

Port of `vslam_tpu.alignment.fused_solve.solve_level_fused`, both entries of
the Pallas kernel: quadratic (`_solve_kernel`) and robust
(`_solve_kernel_robust`), over `_solve_impl`. One launch solves one pyramid
level for all B pairs: one cluster of `CTAS` thread blocks per pair runs
that pair's whole GN loop (warp, project, sample, JᵀWJ / JᵀWr / chi2,
normalization, prior, 6x6 Cholesky, guards, compositional update, history)
and exits at its own convergence; each block takes a fixed contiguous share
of every frame's points. With a robust loss each iteration first caches r
and the visibility (in shared memory where a block's share of every frame
fits there, else in a global scratch buffer that the wrapper allocates, so
any size the JAX entry solves is solved), computes the residual scale from the
cache (median / MAD by an exact radix select of the two central ranks and a
replay of the reference's value bisection, mean, or the t-distribution
fixed point) and then runs the weighted Gram pass. The kernel is
`csrc/fused_solve.cu`.

Two functions with one signature:

* `solve_level_fused` — for CUDA tensors launches the kernel (and raises if
  the build or the launch fails); for CPU tensors runs the plain version.
* `solve_level_fused_plain` — the same computation in batched PyTorch with
  per-pair ``done`` masks, on any device: the CPU path, and the oracle the
  kernel is held against on the card.

The SE(3) exp / log and the re-orthonormalization are the series and
Gram-Schmidt forms the TPU kernel uses (`fused_solve.py:71-127` of the JAX
package), not the exact `core.se3` forms the gather path uses; likewise the
robust scale is the kernel's bisection median, not the gather path's sort.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import se3
from ..core.camera import Camera
from ..core.se3 import SE3
from ..solvers.gauss_newton import SolverResult, gn_decision
from ..solvers.linalg6 import cholesky_logdet_solve
from ..solvers.loss import TUKEY_C
from ..solvers.normal_equations import NormalEquations

__all__ = ["solve_level_fused", "solve_level_fused_plain", "LAUNCHES", "ROBUST_LAUNCHES"]

# kernel launches made by solve_level_fused (one per call on CUDA tensors),
# both entries; ROBUST_LAUNCHES counts those of the robust entry alone
LAUNCHES = 0
ROBUST_LAUNCHES = 0

# loss and scaler codes of the robust entry (fused_solve.cu, SolveParams)
_LOSS_KIND = {"None": 0, "Huber": 1, "Tukey": 2, "tdistribution": 3}
_SCALER_KIND = {"reference": 0, "mad": 1, "mean": 2}
# value-domain bisection steps per rank (fused_solve.py:291 of the JAX
# package), and the t-distribution fixed point's budget and tolerance
_BISECT_STEPS = 24
_TDIST_ITERATIONS = 30
_TDIST_TOL = 1e-5

# output row layout (f32): [A (36), b (6), chi2, iterations, valid,
# delta R (9), delta t (3)] = 57 used
_OUT = 64


# ---------------------------------------------------------------------------
# The kernel's arithmetic, op for op, batched over leading axes
# ---------------------------------------------------------------------------
#
# The plain version evaluates every expression in the order the kernel does
# (and the kernel is compiled with -fmad=false), so on the card the two agree
# to the last bit: the GN exit tests (chi2 increase, relative reduction) then
# fire at the same iteration, which summation noise alone would not
# guarantee on slowly converging pairs.

# threads per block in csrc/fused_solve.cu (kThreads): fixes the sum order
_THREADS = 256
# thread blocks per pair in csrc/fused_solve.cu (kCtas, one cluster), and
# the granule of a block's share of a frame's points (kShareAlign)
CTAS = 4
_SHARE_ALIGN = 16
_WARP = 32
# upper triangle of the 6x6 Gram block, row-major (warp_sample.cuh kGram)
_TRIU = [(a, c) for a in range(6) for c in range(a, 6)]
_TRIU_INDEX = [[_TRIU.index((min(a, c), max(a, c))) for c in range(6)] for a in range(6)]


def _mat3_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([
        torch.stack([a[..., i, 0] * b[..., 0, j] + a[..., i, 1] * b[..., 1, j]
                     + a[..., i, 2] * b[..., 2, j] for j in range(3)], dim=-1)
        for i in range(3)
    ], dim=-2)


def _mat3_vec(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., i, 0] * v[..., 0] + a[..., i, 1] * v[..., 1]
                        + a[..., i, 2] * v[..., 2] for i in range(3)], dim=-1)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _se3_exp_series(xi: torch.Tensor) -> SE3:
    """Rodrigues / V-matrix exp with the coefficients as polynomials in
    theta^2 (f32-exact for the small GN steps; fused_solve.py:71-87)."""
    w = xi[..., 3:6]
    t2 = _dot3(w, w)[..., None, None]
    A = 1.0 - t2 / 6.0 + t2 * t2 / 120.0 - t2 * t2 * t2 / 5040.0
    B = 0.5 - t2 / 24.0 + t2 * t2 / 720.0 - t2 * t2 * t2 / 40320.0
    C = 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0 - t2 * t2 * t2 / 362880.0
    W = se3.so3_hat(w)
    W2 = _mat3_mul(W, W)
    R = _eye3(xi) + A * W + B * W2
    V = _eye3(xi) + B * W + C * W2
    return SE3(R, _mat3_vec(V, xi[..., :3]))


def _se3_log_series(g: SE3) -> torch.Tensor:
    """SE(3) log by series; valid below theta ~ pi/2, the tracking regime
    (fused_solve.py:90-107)."""
    R = g.R
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    s2 = (0.25 * _dot3(v, v))[..., None]  # sin^2 theta
    factor = 0.5 * (1.0 + s2 / 6.0 + 3.0 * s2 * s2 / 40.0 + 15.0 * s2 * s2 * s2 / 336.0)
    phi = factor * v
    t2 = _dot3(phi, phi)[..., None, None]
    cot = 1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0
    W = se3.so3_hat(phi)
    Vinv = _eye3(R) - 0.5 * W + cot * _mat3_mul(W, W)
    return torch.cat([_mat3_vec(Vinv, g.t), phi], dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _orthonormalize_gs(R: torch.Tensor) -> torch.Tensor:
    """Column Gram-Schmidt with sqrt(max(|v|^2, 1e-24)) norms
    (fused_solve.py:110-127)."""
    def unit(v):
        return v / torch.sqrt(torch.clamp(_dot3(v, v), min=1e-24))[..., None]

    x = unit(R[..., :, 0])
    z = unit(_cross(x, R[..., :, 1]))
    return torch.stack([x, _cross(z, x), z], dim=-1)


def _compose(a: SE3, b: SE3) -> SE3:
    return SE3(_mat3_mul(a.R, b.R), _mat3_vec(a.R, b.t) + a.t)


def _block_sum(c: torch.Tensor, ctas: int = 1) -> torch.Tensor:
    """Sum per-point values (..., P, K) over P in the kernel's order. One
    block: thread t adds points t, t + 256, ... in turn; a shuffle-down tree
    sums each warp's 32 lanes; the 8 warp sums are added in sequence. With
    ``ctas`` blocks (the whole-level kernel's cluster), block c sums its
    share [c S, (c + 1) S) of the points, S = 16 ceil(P / 16 ctas), in that
    order, and the blocks' sums are added in rank order."""
    if ctas > 1:
        P = c.shape[-2]
        S = -(-P // (_SHARE_ALIGN * ctas)) * _SHARE_ALIGN
        c = torch.nn.functional.pad(c, (0, 0, 0, ctas * S - P))
        parts = _block_sum(c.reshape(*c.shape[:-2], ctas, S, c.shape[-1]))
        total = parts[..., 0, :]
        for i in range(1, ctas):
            total = total + parts[..., i, :]
        return total
    P = c.shape[-2]
    n = -(-P // _THREADS)
    c = torch.nn.functional.pad(c, (0, 0, 0, n * _THREADS - P))
    c = c.reshape(*c.shape[:-2], n, _THREADS, c.shape[-1])
    acc = c[..., 0, :, :]
    for i in range(1, n):
        acc = acc + c[..., i, :, :]
    acc = acc.reshape(*acc.shape[:-2], _THREADS // _WARP, _WARP, acc.shape[-1])
    o = _WARP // 2
    while o:
        acc = acc[..., :o, :] + acc[..., o : 2 * o, :]
        o //= 2
    acc = acc[..., 0, :]
    total = acc[..., 0, :]
    for w in range(1, _THREADS // _WARP):
        total = total + acc[..., w, :]
    return total


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _prepare_image(image_cur: torch.Tensor, cfg) -> torch.Tensor:
    """The sampled image: a bf16 copy in "bfloat16" mode, else f32."""
    if cfg.image_dtype == "bfloat16":
        return image_cur.to(torch.bfloat16)
    return image_cur.to(torch.float32)


def _sample(data, rel: SE3, img: torch.Tensor, cam: Camera, bilinear: bool):
    """Intensities iwxp and visibility (B, F, P) at rel (B, F): warp, pinhole
    projection, visibility (mask, z > 0, 1 < u < W-1, 1 < v < H-1), nearest
    or bilinear sampling; an invisible point samples pixel (0, 0), as the
    TPU kernel does. A bf16 image's bilinear row weights are rounded to
    bf16, the column weights stay f32 (`warp_sample.cuh` `row_weight`)."""
    B, F, P = data.mask.shape
    H, W = img.shape[-2:]
    R, t = rel.R[..., None, :, :], rel.t[..., None, :]
    p = data.pcl

    def row(i):
        return R[..., i, 0] * p[..., 0] + R[..., i, 1] * p[..., 1] + R[..., i, 2] * p[..., 2] + t[..., i]

    xw, yw, zw = row(0), row(1), row(2)
    z_ok = zw > 0.0
    zi = 1.0 / torch.where(z_ok, zw, torch.ones_like(zw))
    fx, fy, cx, cy = (c.reshape(B, 1, 1) for c in cam)
    u = fx * xw * zi + cx
    v = fy * yw * zi + cy
    visible = data.mask & z_ok & (u > 1.0) & (u < W - 1.0) & (v > 1.0) & (v < H - 1.0)
    zero = torch.zeros_like(u)
    u = torch.where(visible, u, zero)
    v = torch.where(visible, v, zero)

    flat = img.reshape(B, H * W)

    def px_at(iy, ix):
        return torch.gather(flat, 1, (iy * W + ix).reshape(B, F * P)).reshape(B, F, P).float()

    if bilinear:
        u0, v0 = torch.floor(u), torch.floor(v)
        ax, ay = u - u0, v - v0
        wy0, wy1 = 1.0 - ay, ay
        if img.dtype == torch.bfloat16:
            wy0, wy1 = wy0.to(torch.bfloat16).float(), wy1.to(torch.bfloat16).float()
        iu, iv = u0.long(), v0.long()
        iwxp = ((1.0 - ax) * (wy0 * px_at(iv, iu) + wy1 * px_at(iv + 1, iu))
                + ax * (wy0 * px_at(iv, iu + 1) + wy1 * px_at(iv + 1, iu + 1)))
    else:
        iwxp = px_at(torch.floor(v + 0.5).long(), torch.floor(u + 0.5).long())
    return iwxp, visible


def _gram_matrix(sums: torch.Tensor) -> torch.Tensor:
    """The symmetric 6x6 JᵀWJ (..., 6, 6) from its upper triangle in the
    Gram sums (..., 29)."""
    return sums[..., torch.tensor(_TRIU_INDEX, device=sums.device)]


def _sum(x: torch.Tensor, ctas: int) -> torch.Tensor:
    """Sum over the last axis in the kernel's order."""
    return _block_sum(x[..., None], ctas)[..., 0]


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    """An f32 constant on ``like``'s device. Dividing by a tensor keeps the
    division IEEE on the card, where dividing by a Python number multiplies
    by its reciprocal."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _bisect_median(v: torch.Tensor, m: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """The kernel's masked median of v (B, F, P) over m, per (B, F): ranks
    k_lo = floor((n-1)/2) and k_hi = floor(n/2) of the n = n_constraints
    entries, each by 24 halvings of the [min, max] bracket (the k-th value
    is the smallest x with count(m & v <= x) >= k + 1), averaged; 0 when
    n = 0 (fused_solve.py:259-297 of the JAX package). Counts are exact, so
    the order of the count does not matter. The kernel selects the two
    ranks exactly and replays these 24 steps against them, which gives the
    same bits (tests/test_torch_select.py holds the two methods
    together)."""
    inf = torch.full_like(v, float("inf"))
    mn = torch.where(m, v, inf).amin(-1)
    mx = torch.where(m, v, -inf).amax(-1)
    empty = ~(mx >= mn)
    lo = torch.where(empty, torch.zeros_like(mn), mn)[..., None].repeat_interleave(2, -1)
    hi = torch.where(empty, torch.zeros_like(mx), mx)[..., None].repeat_interleave(2, -1)
    k = torch.stack([torch.clamp(torch.floor((n - 1.0) * 0.5), min=0.0),
                     torch.clamp(torch.floor(n * 0.5), min=0.0)], dim=-1)
    for _ in range(_BISECT_STEPS):
        mid = 0.5 * (lo + hi)
        cnt = (m[..., None, :] & (v[..., None, :] <= mid[..., None])).sum(-1).to(torch.float32)
        below = cnt >= k + 1.0
        lo, hi = torch.where(below, lo, mid), torch.where(below, mid, hi)
    med = 0.5 * (hi[..., 0] + hi[..., 1])
    return torch.where(n > 0, med, torch.zeros_like(med))


def _tdist_sigma(r: torch.Tensor, m: torch.Tensor, n: torch.Tensor, v: float, ctas: int) -> torch.Tensor:
    """The t-distribution fixed point sigma^2 <- sum r^2 (v+1) / (v + r^2 /
    sigma^2) / max(n, 1) per (B, F), from sigma = 1, at most 30 steps, each
    frame stopping at its own step <= 1e-5; at least 1e-12."""
    n_safe = torch.clamp(n, min=1.0)
    r2 = torch.where(m, r * r, torch.zeros_like(r))
    vt = _const(v, r)
    vp1 = vt + 1.0
    sigma = torch.ones_like(n)
    active = torch.ones_like(n, dtype=torch.bool)
    for _ in range(_TDIST_ITERATIONS):
        sigma2 = torch.clamp(sigma * sigma, min=1e-24)
        acc = _sum(r2 * vp1 / (vt + r2 / sigma2[..., None]), ctas)
        sigma_new = torch.sqrt(acc / n_safe)
        step = torch.abs(sigma - sigma_new)
        sigma = torch.where(active, sigma_new, sigma)
        active = active & (step > _TDIST_TOL)
        if not bool(active.any()):
            break
    return torch.clamp(sigma, min=1e-12)


def _robust_scale(r: torch.Tensor, m: torch.Tensor, n: torch.Tensor, loss_cfg, ctas: int):
    """(offset, sigma) (B, F) of the cached residuals r (zero where
    invisible) over the interest mask m, by the kernel's methods."""
    zero = torch.zeros_like(r)
    if loss_cfg.function == "tdistribution":
        sigma = _tdist_sigma(r, m, n, loss_cfg.tdistribution_v, ctas)
        return torch.zeros_like(sigma), sigma
    if loss_cfg.scaler == "mean":
        mean = _sum(torch.where(m, r, zero), ctas) / torch.clamp(n, min=1.0)
        dev = _sum(torch.where(m, torch.abs(r - mean[..., None]), zero), ctas)
        std = torch.sqrt(dev / torch.clamp(n - 1.0, min=1.0))
        empty = n < 1.0
        return (torch.where(empty, torch.zeros_like(mean), mean),
                torch.where(empty | (std <= 0), torch.ones_like(std), std))
    med = _bisect_median(r, m, n)
    if loss_cfg.scaler == "mad":
        sigma = 1.4826 * _bisect_median(torch.abs(r - med[..., None]), m, n)
        return med, torch.where(sigma > 1e-6, sigma, torch.ones_like(sigma))
    dev = _sum(torch.where(m, torch.abs(r - med[..., None]), zero), ctas)
    std = torch.sqrt(dev / torch.clamp(n - 1.0, min=1.0))
    return med, torch.where(std > 0, std, torch.ones_like(std))


def _robust_weight(r_std: torch.Tensor, loss_cfg) -> torch.Tensor:
    """M-estimator weight of the standardized residual, as the kernel
    evaluates it (Huber's 1/|r| outlier weight included)."""
    if loss_cfg.function == "Huber":
        a = torch.abs(r_std)
        return torch.where(a < _const(loss_cfg.huber_c, a), torch.ones_like(a),
                           1.0 / torch.clamp(a, min=1e-30))
    if loss_cfg.function == "Tukey":
        c = _const(TUKEY_C, r_std)
        rc = r_std / c
        t = 1.0 - rc * rc
        return torch.where(torch.abs(r_std) < c, t * t, torch.zeros_like(t))
    vt = _const(loss_cfg.tdistribution_v, r_std)
    return (vt + 1.0) / (vt + r_std * r_std)


def _frame_sums(data, rel: SE3, img: torch.Tensor, cam: Camera, bilinear: bool, loss_cfg,
                ctas: int) -> torch.Tensor:
    """Per-frame raw Gram sums (B, F, 29) at rel (B, F) over the visible
    points: upper JᵀWJ (21), JᵀWr (6), Σ w r², visible count. W is 1
    (quadratic loss) or the robust weight of the scale computed from this
    iteration's residuals."""
    iwxp, visible = _sample(data, rel, img, cam, bilinear)
    r = iwxp - data.templ
    J = data.J
    if loss_cfg.function == "None":
        terms = [J[..., a] * J[..., c] for a, c in _TRIU]
        terms += [J[..., a] * r for a in range(6)] + [r * r]
    else:
        r = torch.where(visible, r, torch.zeros_like(r))  # the kernel's residual cache
        offset, sigma = _robust_scale(r, data.mask, data.n_constraints, loss_cfg, ctas)
        w = _robust_weight((r - offset[..., None]) / sigma[..., None], loss_cfg)
        wj = J * w[..., None]
        terms = [wj[..., a] * J[..., c] for a, c in _TRIU]
        terms += [wj[..., a] * r for a in range(6)] + [w * r * r]
    per_point = torch.stack(terms + [torch.ones_like(r)], dim=-1)
    per_point = torch.where(visible[..., None], per_point, torch.zeros_like(per_point))
    return _block_sum(per_point, ctas)


def _fused_ne(data, rel: SE3, img, cam, cfg, include_prior, x_pred, ctas) -> NormalEquations:
    """Stacked normalized NE: per frame, divide by the interest-point count
    (1 when n <= 1), then add the prior (x 1/255^2, + w I, b += w (x - x_pred)
    with the series log of the frame's pose); sum over the frames."""
    sums = _frame_sums(data, rel, img, cam, cfg.interpolation == "bilinear", cfg.loss, ctas)
    n = data.n_constraints
    inv_n = torch.where(n > 1, 1.0 / torch.clamp(n, min=1.0), torch.ones_like(n))
    A = _gram_matrix(sums) * inv_n[..., None, None]
    b = sums[..., 21:27] * inv_n[..., None]
    chi2 = sums[..., 27] * inv_n
    if include_prior:
        nrm = 1.0 / (255.0 * 255.0)
        eye6 = torch.eye(6, dtype=A.dtype, device=A.device)
        A = A * nrm + cfg.prior_weight * eye6
        b = b * nrm + cfg.prior_weight * (_se3_log_series(rel) - x_pred)
    F = A.shape[1]
    out = [A[:, 0], b[:, 0], chi2[:, 0], n[:, 0]]
    for f in range(1, F):
        out = [out[0] + A[:, f], out[1] + b[:, f], out[2] + chi2[:, f], out[3] + n[:, f]]
    return NormalEquations(*out)


def _result(rel0: SE3, Rd, td, A, b, chi2, iterations, chist, shist):
    from .ic import _LevelState, _broadcast

    delta = SE3(Rd, td)
    result = SolverResult(
        x=_LevelState(delta), A=A, b=b, chi2=chi2, iterations=iterations,
        valid=iterations > 0, chi2_history=chist, step_history=shist,
    )
    return se3.compose(rel0, _broadcast(delta, rel0)), result


def solve_level_fused_plain(data, rel0: SE3, image_cur, cam_cur: Camera, cfg, x_pred, *, ctas: int = CTAS):
    """Batched PyTorch re-enactment of the whole-level kernel, on any device.

    Same arguments and results as `solve_level_fused`: data leaves
    (B, F, ...), rel0 (B, F), image_cur (B, H, W), cam_cur leaves (B,),
    x_pred (B, F, 6) or None. Returns (rel0 . delta (B, F), SolverResult).
    History rows hold chi2 and step of every evaluated iteration; A, b and
    chi2 are those of the last accepted one (identity, zero, +inf before).
    ``ctas`` is the kernel's blocks per pair, which fixes its sum order."""
    B, F, _ = data.templ.shape
    dev = data.templ.device
    img = _prepare_image(image_cur, cfg)
    include_prior = bool(cfg.include_prior and x_pred is not None)
    s = cfg.solver
    n_it = int(s.max_iterations)

    Rd = torch.eye(3, device=dev).expand(B, 3, 3).clone()
    td = torch.zeros(B, 3, device=dev)
    A_out = torch.eye(6, device=dev).expand(B, 6, 6).clone()
    b_out = torch.zeros(B, 6, device=dev)
    chi2_prev = torch.full((B,), float("inf"), device=dev)
    pushed = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    chist = torch.full((B, n_it), float("nan"), device=dev)
    shist = torch.full((B, n_it), float("nan"), device=dev)

    for i in range(n_it):
        if bool(done.all()):
            break
        live = ~done
        delta = SE3(Rd[:, None].expand(-1, F, -1, -1), td[:, None].expand(-1, F, -1))
        rel = _compose(rel0, delta)
        ne = _fused_ne(data, rel, img, cam_cur, cfg, include_prior, x_pred, ctas)
        dx, logdet = cholesky_logdet_solve(ne.A, ne.b)
        step, accepted, stop = gn_decision(ne, dx, logdet, chi2_prev, pushed, s)

        e = _se3_exp_series(-dx)
        R_new = _mat3_mul(Rd, e.R)
        t_new = _mat3_vec(Rd, e.t) + td
        if cfg.orthonormalize:
            R_new = _orthonormalize_gs(R_new)

        take = live & accepted
        Rd = torch.where(take[:, None, None], R_new, Rd)
        td = torch.where(take[:, None], t_new, td)
        A_out = torch.where(take[:, None, None], ne.A, A_out)
        b_out = torch.where(take[:, None], ne.b, b_out)
        chi2_prev = torch.where(take, ne.chi2, chi2_prev)
        pushed = pushed + take.to(torch.int32)
        chist[:, i] = torch.where(live, ne.chi2, chist[:, i])
        shist[:, i] = torch.where(live, step, shist[:, i])
        done = done | stop
    return _result(rel0, Rd, td, A_out, b_out, chi2_prev, pushed, chist, shist)


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------


def _checked(name: str, x: torch.Tensor, shape, dtype) -> torch.Tensor:
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return x


def _launch(data, rel0: SE3, image_cur, cam_cur: Camera, cfg, x_pred, lib=None):
    """Validate, allocate with torch.empty and launch on the current stream:
    the quadratic entry for loss "None", else the robust entry, given a
    global residual cache where the blocks' shares of the frames do not fit
    theirs in shared memory. ``lib`` is the kernel library (default: the
    package's build)."""
    global LAUNCHES, ROBUST_LAUNCHES
    from .._build import library

    B, F, P = data.templ.shape
    H, W = image_cur.shape[-2:]
    dev = data.templ.device
    f32 = torch.float32
    include_prior = bool(cfg.include_prior and x_pred is not None)
    if x_pred is None:
        x_pred = torch.zeros(B, F, 6, dtype=f32, device=dev)
    img = _prepare_image(image_cur, cfg).contiguous()
    cam = torch.stack([c.reshape(B) for c in cam_cur], dim=1).to(f32).contiguous()
    s = cfg.solver
    n_it = int(s.max_iterations)
    args = [
        _checked("pcl", data.pcl, (B, F, P, 3), f32),
        _checked("J", data.J, (B, F, P, 6), f32),
        _checked("templ", data.templ, (B, F, P), f32),
        _checked("mask", data.mask, (B, F, P), torch.bool),
        _checked("n_constraints", data.n_constraints, (B, F), f32),
        _checked("rel0.R", rel0.R, (B, F, 3, 3), f32),
        _checked("rel0.t", rel0.t, (B, F, 3), f32),
        _checked("x_pred", x_pred, (B, F, 6), f32),
        _checked("cam", cam, (B, 4), f32),
        _checked("image", img, (B, H, W), img.dtype),
    ]
    if img.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"image: expected float32 or bfloat16, got {img.dtype}")
    if min(B, F, P, H, W) < 1:
        raise ValueError(f"empty problem: B={B} F={F} P={P} H={H} W={W}")
    out = torch.empty(B, _OUT, dtype=f32, device=dev)
    chist = torch.empty(B, max(n_it, 1), dtype=f32, device=dev)
    shist = torch.empty(B, max(n_it, 1), dtype=f32, device=dev)
    min_rel = s.min_relative_reduction
    scalars = [
        ctypes.c_int(int(img.dtype == torch.bfloat16)),
        ctypes.c_int(B), ctypes.c_int(F), ctypes.c_int(P), ctypes.c_int(H), ctypes.c_int(W),
        ctypes.c_int(int(cfg.interpolation == "bilinear")),
        ctypes.c_int(int(include_prior)),
        ctypes.c_float(cfg.prior_weight),
        ctypes.c_int(n_it),
        ctypes.c_float(s.min_step_size),
        ctypes.c_float(s._min_gradient),
        ctypes.c_float(s._min_reduction),
        ctypes.c_float(0.0 if min_rel is None else min_rel),
        ctypes.c_int(int(min_rel is not None)),
        ctypes.c_int(int(cfg.orthonormalize)),
    ]
    robust = cfg.loss.function != "None"
    if robust:
        scalars += [
            ctypes.c_int(_LOSS_KIND[cfg.loss.function]),
            ctypes.c_int(_SCALER_KIND[cfg.loss.scaler]),
            ctypes.c_float(cfg.loss.huber_c),
            ctypes.c_float(cfg.loss.tdistribution_v),
        ]
    lib = library() if lib is None else lib
    with torch.cuda.device(dev):
        need, limit = ctypes.c_int(0), ctypes.c_int(0)
        err = lib.vslam_solve_level_smem(F, P, int(robust), ctypes.byref(need), ctypes.byref(limit))
        if err != 0:
            raise RuntimeError(f"fused_solve kernel: shared-memory query failed: CUDA error {err}")
        cache = []
        if robust:
            cache = [None, None]  # the residual cache fits in shared memory
            if need.value > limit.value:
                points = ctypes.c_int(0)
                lib.vslam_solve_level_global_cache(F, P, ctypes.byref(points), ctypes.byref(need))
                cache = [torch.empty(B * points.value, dtype=f32, device=dev),
                         torch.empty(B * points.value, dtype=torch.uint8, device=dev)]
        if need.value > limit.value:
            raise ValueError(f"fused_solve kernel: F={F} frames of P={P} points need {need.value} B of "
                             f"shared memory per block, above the card's {limit.value} B")
        ptrs = [ctypes.c_void_p(None if a is None else a.data_ptr()) if not isinstance(a, ctypes._SimpleCData)
                else a for a in args + scalars + cache + [out, chist, shist]]
        stream = torch.cuda.current_stream(dev).cuda_stream
        entry = lib.vslam_solve_level_fused_robust if robust else lib.vslam_solve_level_fused
        err = entry(*ptrs, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"fused_solve kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    ROBUST_LAUNCHES += int(robust)
    return out, chist[:, :n_it], shist[:, :n_it]


def solve_level_fused(data, rel0: SE3, image_cur, cam_cur: Camera, cfg, x_pred):
    """Whole-level GN, one kernel launch for all B pairs (CUDA tensors) or
    the plain version (CPU tensors). Arguments and results as
    `solve_level_fused_plain`."""
    if data.templ.device.type == "cpu":
        return solve_level_fused_plain(data, rel0, image_cur, cam_cur, cfg, x_pred)
    return _from_out(rel0, *_launch(data, rel0, image_cur, cam_cur, cfg, x_pred))


def _from_out(rel0: SE3, out, chist, shist):
    """(rel0 . delta, SolverResult) from the kernel's output rows."""
    B = out.shape[0]
    return _result(
        rel0,
        out[:, 45:54].reshape(B, 3, 3),
        out[:, 54:57],
        out[:, 0:36].reshape(B, 6, 6),
        out[:, 36:42],
        out[:, 42],
        out[:, 43].to(torch.int32),
        chist,
        shist,
    )
