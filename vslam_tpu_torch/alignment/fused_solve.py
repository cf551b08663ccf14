"""Whole-level Gauss-Newton solve as one CUDA kernel per pyramid level.

Port of `vslam_tpu.alignment.fused_solve.solve_level_fused`, quadratic-loss
entry (the Pallas `_solve_kernel` over `_solve_impl`). One launch solves one
pyramid level for all B pairs: one thread block per pair runs that pair's
whole GN loop (warp, project, sample, JᵀWJ / JᵀWr / chi2, normalization,
prior, 6x6 Cholesky, guards, compositional update, history) and exits at
its own convergence. The kernel is `csrc/fused_solve.cu`.

Two functions with one signature:

* `solve_level_fused` — for CUDA tensors launches the kernel (and raises if
  the build or the launch fails); for CPU tensors runs the plain version.
* `solve_level_fused_plain` — the same computation in batched PyTorch with
  per-pair ``done`` masks, on any device: the CPU path, and the oracle the
  kernel is held against on the card.

The SE(3) exp / log and the re-orthonormalization are the series and
Gram-Schmidt forms the TPU kernel uses (`fused_solve.py:71-127` of the JAX
package), not the exact `core.se3` forms the gather path uses.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import se3
from ..core.camera import Camera
from ..core.se3 import SE3
from ..solvers.gauss_newton import SolverResult, gn_decision
from ..solvers.linalg6 import cholesky_logdet_solve
from ..solvers.normal_equations import NormalEquations

__all__ = ["solve_level_fused", "solve_level_fused_plain", "LAUNCHES"]

# kernel launches made by solve_level_fused (one per call on CUDA tensors)
LAUNCHES = 0

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


def _block_sum(c: torch.Tensor) -> torch.Tensor:
    """Sum per-point values (..., P, K) over P in the kernel's order: thread
    t adds points t, t + 256, ... in turn; a shuffle-down tree sums each
    warp's 32 lanes; the 8 warp sums are added in sequence."""
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


def _frame_sums(data, rel: SE3, img: torch.Tensor, cam: Camera, bilinear: bool) -> torch.Tensor:
    """Per-frame raw Gram sums (B, F, 29) at rel (B, F): warp, pinhole
    projection, visibility (mask, z > 0, 1 < u < W-1, 1 < v < H-1),
    nearest or bilinear sampling, residual; upper JᵀJ (21), Jᵀr (6), r²,
    visible count."""
    B, F, P = data.templ.shape
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
        iu, iv = u0.long(), v0.long()
        iwxp = ((1.0 - ax) * ((1.0 - ay) * px_at(iv, iu) + ay * px_at(iv + 1, iu))
                + ax * ((1.0 - ay) * px_at(iv, iu + 1) + ay * px_at(iv + 1, iu + 1)))
    else:
        iwxp = px_at(torch.floor(v + 0.5).long(), torch.floor(u + 0.5).long())
    r = iwxp - data.templ
    J = data.J
    terms = [J[..., a] * J[..., c] for a, c in _TRIU]
    terms += [J[..., a] * r for a in range(6)] + [r * r, torch.ones_like(r)]
    per_point = torch.stack(terms, dim=-1)
    per_point = torch.where(visible[..., None], per_point, torch.zeros_like(per_point))
    return _block_sum(per_point)


def _fused_ne(data, rel: SE3, img, cam, cfg, include_prior, x_pred) -> NormalEquations:
    """Stacked normalized NE: per frame, divide by the interest-point count
    (1 when n <= 1), then add the prior (x 1/255^2, + w I, b += w (x - x_pred)
    with the series log of the frame's pose); sum over the frames."""
    sums = _frame_sums(data, rel, img, cam, cfg.interpolation == "bilinear")
    n = data.n_constraints
    inv_n = torch.where(n > 1, 1.0 / torch.clamp(n, min=1.0), torch.ones_like(n))
    idx = torch.tensor(_TRIU_INDEX, device=sums.device)
    A = sums[..., idx] * inv_n[..., None, None]
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


def solve_level_fused_plain(data, rel0: SE3, image_cur, cam_cur: Camera, cfg, x_pred):
    """Batched PyTorch re-enactment of the whole-level kernel, on any device.

    Same arguments and results as `solve_level_fused`: data leaves
    (B, F, ...), rel0 (B, F), image_cur (B, H, W), cam_cur leaves (B,),
    x_pred (B, F, 6) or None. Returns (rel0 . delta (B, F), SolverResult).
    History rows hold chi2 and step of every evaluated iteration; A, b and
    chi2 are those of the last accepted one (identity, zero, +inf before)."""
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
        ne = _fused_ne(data, rel, img, cam_cur, cfg, include_prior, x_pred)
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


def _launch(data, rel0: SE3, image_cur, cam_cur: Camera, cfg, x_pred):
    """Validate, allocate with torch.empty and launch on the current stream."""
    global LAUNCHES
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
    ptrs = [ctypes.c_void_p(a.data_ptr()) for a in args]
    min_rel = s.min_relative_reduction
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().vslam_solve_level_fused(
            *ptrs,
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
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(chist.data_ptr()),
            ctypes.c_void_p(shist.data_ptr()),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"fused_solve kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out, chist[:, :n_it], shist[:, :n_it]


def solve_level_fused(data, rel0: SE3, image_cur, cam_cur: Camera, cfg, x_pred):
    """Whole-level GN, one kernel launch for all B pairs (CUDA tensors) or
    the plain version (CPU tensors). Arguments and results as
    `solve_level_fused_plain`."""
    if data.templ.device.type == "cpu":
        return solve_level_fused_plain(data, rel0, image_cur, cam_cur, cfg, x_pred)
    out, chist, shist = _launch(data, rel0, image_cur, cam_cur, cfg, x_pred)
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
