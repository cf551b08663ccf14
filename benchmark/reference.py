"""The plain reference the benchmark holds the port's output against.

Plain PyTorch on any device. It imports nothing of `vslam_tpu_torch` (nor
JAX) and takes nothing the program made: from the sensor images the
benchmark rendered it builds every pyramid, stereo depth map, interest-point
list, Gauss-Newton solve and pose again. It is a frozen restatement of the
port's plain semantics (the JAX package's, the reference C++ tracker's):

- frame build: uint8 intensity to f32, uint16 depth counts times the step;
  cv::pyrDown levels, depth by the invalid-masked 3x3 median on pyrDown's
  grid, Sobel derivatives of the 3x3 Gaussian blur (Frame.cpp:215-275);
- stereo depth: the SAD cost volume of 9x9 box windows over D disparities,
  argmin, parabolic sub-pixel refinement, the 0.98 uniqueness test and the
  left-right check, depth = fx * b / disparity;
- precompute: interest points |grad|^2 >= min_gradient^2 on a valid 3x3
  depth window, the block-stratified fixed-capacity selection (2-row
  blocks), back-projection and the analytic steepest-descent rows;
- the level solve: inverse-compositional Gauss-Newton over a delta shared by
  the stacked reference frames, bilinear samples of the configuration's
  image copy (bfloat16), residuals normalized by the interest-point count,
  the 1/255^2 motion prior, the reference's guards and stops
  (GaussNewton.cpp:33-102 with the relative-reduction stop), exact SE(3)
  exp / log;
- the scan: ConstantMotion prediction, joint alignment against {keyframe,
  last frame}, the speed update and the keyframe policy (every
  ``kf_period`` frames or a translation above ``kf_max_translation``).

Every solve also logs, per pair, the Gauss-Newton iterations it evaluated
and its interest points: the work that `work.py` counts.

``Profile.dtype`` is the type the reference computes in: float32, the
configuration's, for the check; bfloat16, the next precision below, for the
check's control (the 6x6 factorization, which PyTorch has in float32 only,
then runs on the bfloat16 values and its result is rounded back).
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as Fn

__all__ = ["Profile", "profile", "Level", "run_suite", "run_pairs", "frame_pyramid", "sensor_values",
           "stereo_depth", "se3_log"]

_BIG = 1e9  # the cost of a disparity with no right-image support
BLOCK = 9  # the block matcher's SAD window, fixed in the port's matcher
UNIQUENESS = 0.98  # the best cost against the runner-up outside +-1
_LOG_MIN_DET = float(torch.log(torch.tensor(1e-6)))


class Profile(NamedTuple):
    """What a configuration file states, as the reference reads it."""

    levels: int
    depth_step: float  # metres a depth count; 0 for a stereo rig
    baseline: float
    max_disparity: int
    min_gradient: float
    max_points: int
    image_dtype: torch.dtype
    include_prior: bool
    prior_weight: float
    max_iterations: int
    min_step_size: float
    min_relative_reduction: Optional[float]
    kf_period: int
    kf_max_translation: float
    dtype: torch.dtype = torch.float32  # what the reference computes in


def profile(config: dict, dtype: torch.dtype = torch.float32) -> Profile:
    s, o, a = config["sensor"], config["odometry"], config["alignment"]
    if (a["sampler"], a["interpolation"], a["loss"], o["prediction"]) != ("fused_gn", "bilinear", "None",
                                                                          "ConstantMotion"):
        raise ValueError("the reference states the quadratic, bilinear, ConstantMotion profile only")
    if not o["include_key_frame"]:
        raise ValueError("the reference aligns against {keyframe, last frame}")
    stereo = s["kind"] == "stereo"
    return Profile(
        levels=int(o["levels"]), depth_step=0.0 if stereo else float(s["depth_scale_m"]),
        baseline=float(s.get("baseline_m", 0.0)), max_disparity=int(s.get("max_disparity", 0)),
        min_gradient=float(a["min_gradient"]), max_points=int(a["max_points"]),
        image_dtype=getattr(torch, a["image_dtype"]), include_prior=bool(a["include_prior"]),
        prior_weight=float(a["prior_weight"]), max_iterations=int(a["max_iterations"]),
        min_step_size=float(a["min_step_size"]), min_relative_reduction=a.get("min_relative_reduction"),
        kf_period=int(o["kf_period"]), kf_max_translation=float(o["kf_max_translation_m"]),
        dtype=dtype)


@contextlib.contextmanager
def exact_f32():
    """Matrix products and convolutions in true f32 (no TF32) while the
    reference runs; the previous settings come back after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# ---------------------------------------------------------------------------
# SE(3): (R (..., 3, 3), t (..., 3)), xi = [translation; rotation]


def _hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _mv(R, t):
    return (R @ t[..., None])[..., 0]


def compose(a, b):
    return a[0] @ b[0], _mv(a[0], b[1]) + a[1]


def inverse(g):
    Rt = g[0].transpose(-1, -2)
    return Rt, -_mv(Rt, g[1])


def identity(shape, device, dtype=torch.float32):
    return (torch.eye(3, dtype=dtype, device=device).expand(*shape, 3, 3).clone(),
            torch.zeros(*shape, 3, dtype=dtype, device=device))


def se3_exp(xi):
    phi = xi[..., 3:]
    th2 = (phi * phi).sum(-1)
    th2s = th2.clamp(min=1e-24)
    th = th2s.sqrt()
    small = th2 < 1e-8
    A = torch.where(small, 1 - th2 / 6, torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(th)) / th2s)
    C = torch.where(small, 1 / 6 - th2 / 120, (th - torch.sin(th)) / (th2s * th))
    W = _hat(phi)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    return R, _mv(V, xi[..., :3])


def se3_log(g):
    """Below a rotation of pi (the tracking regime)."""
    R, t = g
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], -1)
    s = ((vee * vee).sum(-1) * 0.25).clamp(min=1e-30).sqrt()
    th = torch.atan2(s, ((tr - 1) * 0.5).clamp(-1.0, 1.0))
    phi = torch.where(th < 1e-4, 0.5 + th * th / 12, th / (2 * s).clamp(min=1e-24))[..., None] * vee
    th2 = (phi * phi).sum(-1)
    th2s = th2.clamp(min=1e-24)
    half = 0.5 * th2s.sqrt()
    cot = torch.where(th2 < 1e-8, 1 / 12 + th2 / 720,
                      (1 - half * torch.cos(half) / torch.sin(half).clamp(min=1e-24)) / th2s)
    W = _hat(phi)
    Vinv = torch.eye(3, dtype=R.dtype, device=R.device) - 0.5 * W + cot[..., None, None] * (W @ W)
    return torch.cat([_mv(Vinv, t), phi], -1)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1], a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def orthonormalize(g):
    """Gram-Schmidt of the first two columns."""
    R = g[0]
    x = R[..., :, 0] / R[..., :, 0].norm(dim=-1, keepdim=True).clamp(min=1e-24)
    z = _cross(x, R[..., :, 1])
    z = z / z.norm(dim=-1, keepdim=True).clamp(min=1e-24)
    return torch.stack([x, _cross(z, x), z], -1), g[1]


def _where(pred, a, b):
    """Leaf-wise select of pose tuples / tensors with pred (N,)."""
    if isinstance(a, tuple):
        return tuple(_where(pred, u, v) for u, v in zip(a, b))
    return torch.where(pred.view(-1, *([1] * (a.dim() - 1))), a, b)


# ---------------------------------------------------------------------------
# Images (..., H, W)


def _reflect(img, p):
    """Reflect-101 padding of the last two axes by p."""
    lead = img.shape[:-2]
    x = Fn.pad(img.reshape(-1, 1, *img.shape[-2:]), (p, p, p, p), mode="reflect")
    return x.reshape(*lead, *x.shape[-2:])


def _correlate(padded, taps, dim):
    """One separable pass: sum_i taps[i] * the i-th shifted slice."""
    n = padded.shape[dim] - (len(taps) - 1)
    out = None
    for i, w in enumerate(taps):
        if w == 0.0:
            continue
        sl = padded.narrow(dim, i, n)
        term = sl if w == 1.0 else w * sl
        out = term.clone() if out is None else out + term
    return out


def _separable(img, ky, kx):
    p = len(ky) // 2
    x = _reflect(img, p)
    return _correlate(_correlate(x, ky, -2), kx, -1)


def blur3(img):
    return _separable(img, (0.25, 0.5, 0.25), (0.25, 0.5, 0.25))


def sobel_x(img):
    return _separable(img, (1.0, 2.0, 1.0), (-1.0, 0.0, 1.0))


def sobel_y(img):
    return _separable(img, (-1.0, 0.0, 1.0), (1.0, 2.0, 1.0))


def pyr_down(img):
    """cv::pyrDown: [1 4 6 4 1]/16 both ways, reflect-101, every other
    row and column kept."""
    taps = (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)
    x = _reflect(img, 2)
    return _correlate(_correlate(x, taps, -2)[..., ::2, :], taps, -1)[..., ::2]


def median3_masked(img, invalid, chunk: int = 64):
    """3x3 median over the valid neighbours (the mean of the two central
    ranks), 0 with none and on the border rows and columns; ``chunk``
    images at a time, so that the sorted windows stay small."""
    if img.shape[0] > chunk:
        return torch.cat([median3_masked(img[i:i + chunk], invalid[i:i + chunk], chunk)
                          for i in range(0, img.shape[0], chunk)])
    H, W = img.shape[-2:]
    v = Fn.pad(torch.where(invalid, torch.full_like(img, float("inf")), img), (1, 1, 1, 1), value=float("inf"))
    m = Fn.pad((~invalid).to(torch.int64), (1, 1, 1, 1))
    win = torch.stack([v[..., dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)], -1)
    n = sum(m[..., dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3))
    s = win.sort(-1).values
    lo = torch.gather(s, -1, ((n - 1) // 2).clamp(min=0)[..., None])[..., 0]
    hi = torch.gather(s, -1, (n // 2).clamp(max=8)[..., None])[..., 0]
    med = torch.where(n > 0, 0.5 * (lo + hi), torch.zeros_like(img))
    out = torch.zeros_like(med)
    out[..., 1:-1, 1:-1] = med[..., 1:-1, 1:-1]
    return out


def sensor_values(x, step: float, dtype=torch.float32):
    """A uint8 image to grey levels, or int16 bits of uint16 depth counts to
    metres, in ``dtype``."""
    if x.dtype == torch.int16:
        return (x.to(torch.int32) & 0xFFFF).to(dtype) * step
    return x.to(dtype)


def stereo_depth(left, right, fx, prof: Profile):
    """Metric depth (N, H, W) of rectified f32 pairs (N, H, W), fx (N,)."""
    N, H, W = left.shape
    D = prof.max_disparity
    taps = (1.0 / BLOCK,) * BLOCK
    cost = torch.empty(N, D, H, W, dtype=left.dtype, device=left.device)
    for d in range(D):
        shifted = torch.zeros_like(right)
        shifted[..., d:] = right[..., :W - d]
        cost[:, d] = _separable((left - shifted).abs(), taps, taps)
        cost[:, d, :, :d] = _BIG
    d_best = cost.argmin(1, keepdim=True)  # the first of equal costs
    c_best = cost.gather(1, d_best)
    c_m = cost.gather(1, (d_best - 1).clamp(0, D - 1))
    c_p = cost.gather(1, (d_best + 1).clamp(0, D - 1))
    den = c_m - 2 * c_best + c_p
    delta = torch.where(den.abs() > 1e-6, 0.5 * (c_m - c_p) / den.clamp(min=1e-6), torch.zeros_like(den))
    disp = d_best.to(left.dtype) + delta.clamp(-0.5, 0.5)
    dd = torch.arange(D, device=left.device).view(1, D, 1, 1)
    runner_up = torch.where((dd >= d_best - 1) & (dd <= d_best + 1), torch.full_like(cost, _BIG), cost).amin(1, True)
    valid = (d_best > 0) & (d_best < D - 1) & (c_best <= UNIQUENESS * runner_up) & (c_best < _BIG)
    # left-right check: the right image's best disparity at x - d
    cost_r = torch.full_like(cost, _BIG)
    for d in range(D):
        cost_r[:, d, :, :W - d] = cost[:, d, :, d:]
    d_right = cost_r.argmin(1, keepdim=True)
    del cost, cost_r
    x_r = (torch.arange(W, device=left.device) - d_best).clamp(0, W - 1)
    valid = valid & ((d_right.gather(-1, x_r) - d_best).abs() <= 1)
    disp = torch.where(valid, disp, torch.zeros_like(disp))[:, 0]
    fxb = (fx.to(disp.dtype) * prof.baseline).view(N, 1, 1)
    return torch.where(disp > 0.5, torch.div(fxb, disp.clamp(min=0.5)), torch.zeros_like(disp))


class Pyramid(NamedTuple):
    intensity: List[torch.Tensor]
    depth: List[torch.Tensor]
    dx: List[torch.Tensor]
    dy: List[torch.Tensor]
    cams: List[tuple]  # (fx, fy, cx, cy) tensors (N,) per level


def frame_pyramid(intensity, depth, cam, levels: int) -> Pyramid:
    """intensity, depth (N, H, W) f32; cam a tuple of (N,) tensors."""
    depth = torch.where(torch.isfinite(depth), depth, torch.zeros_like(depth))
    inten, dep, cams = [intensity], [depth], [cam]
    for lvl in range(1, levels):
        inten.append(pyr_down(inten[-1]))
        dep.append(median3_masked(dep[-1], dep[-1] <= 0.0)[..., ::2, ::2])
        cams.append(tuple(c * 0.5 ** lvl for c in cam))
    blurred = [blur3(x) for x in inten]
    return Pyramid(inten, dep, [sobel_x(b) for b in blurred], [sobel_y(b) for b in blurred], cams)


# ---------------------------------------------------------------------------
# Interest points


class Level(NamedTuple):
    """Per (N, P) interest-point data of one level."""

    pcl: torch.Tensor  # (N, P, 3)
    J: torch.Tensor  # (N, P, 6)
    templ: torch.Tensor  # (N, P)
    mask: torch.Tensor  # (N, P) bool
    n: torch.Tensor  # (N,) interest points


def _valid3x3(depth):
    ok = torch.isfinite(depth) & (depth > 0.0)
    H, W = ok.shape[-2:]
    p = Fn.pad(ok.to(torch.uint8), (1, 1, 1, 1)).bool()
    out = torch.ones_like(ok)
    for dy in range(3):
        for dx in range(3):
            out = out & p[..., dy:dy + H, dx:dx + W]
    return out


def _steepest(p, gx, gy, fx, fy):
    """grad I . d(uv)/d(xi) at camera points p (N, P, 3) (Warp.cpp:166-201)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    zi = 1.0 / torch.where(z > 0, z, torch.ones_like(z))
    zero = torch.zeros_like(x)
    a = -x * zi * zi
    c = -y * zi * zi
    r0 = torch.stack([zi, zero, a, y * a, 1.0 - x * a, -y * zi], -1) * fx[:, None, None]
    r1 = torch.stack([zero, zi, c, -1.0 + y * c, -y * a, x * zi], -1) * fy[:, None, None]
    return gx[..., None] * r0 + gy[..., None] * r1


def interest_points(inten, dx, dy, depth, cam, min_gradient: float, budget: int) -> Level:
    """The block-stratified selection: 2-row blocks, block k keeps kb =
    budget // blocks slots, slot s the floor(s * count / kb) + 1 -th
    interest pixel of the block in row-major order; repeated or missing
    ranks are empty slots."""
    N, H, W = inten.shape
    if budget >= H * W or budget <= 0:
        raise ValueError("the reference states the fixed-budget selection only")
    rows = 2
    nb = -(-H // rows)
    kb = max(budget // nb, 1)
    ok3 = _valid3x3(depth)
    mask = ((dx * dx + dy * dy) >= min_gradient * min_gradient) & ok3
    mask = Fn.pad(mask, (0, 0, 0, nb * rows - H)).reshape(N, nb, rows * W)
    run = torch.cumsum(mask.to(torch.int64), -1)
    count = run[..., -1:]
    ranks = torch.arange(kb, device=inten.device) * count // kb + 1  # (N, nb, kb)
    repeat = torch.zeros_like(ranks, dtype=torch.bool)
    repeat[..., 1:] = ranks[..., 1:] == ranks[..., :-1]
    exists = count >= ranks
    pos = torch.searchsorted(run, ranks)
    pix = torch.where(exists, torch.arange(nb, device=inten.device)[:, None] * rows * W + pos,
                      torch.zeros_like(pos)).reshape(N, nb * kb)
    valid = (exists & ~repeat).reshape(N, nb * kb)
    exists = exists.reshape(N, nb * kb)

    def take(img):
        v = img.reshape(N, H * W).gather(1, pix)
        return torch.where(exists, v, torch.zeros_like(v))

    zero = torch.zeros_like(pix, dtype=inten.dtype)
    u = torch.where(exists, (pix % W).to(inten.dtype), zero)
    v = torch.where(exists, (pix // W).to(inten.dtype), zero)
    z = torch.where(valid, take(torch.where(ok3, depth, torch.zeros_like(depth))), torch.zeros_like(u))
    fx, fy, cx, cy = (c.view(N, 1) for c in cam)
    pcl = torch.stack([(u - cx) / fx * z, (v - cy) / fy * z, z], -1)
    J = _steepest(pcl, take(dx), take(dy), cam[0], cam[1])
    keep = valid & (z > 0.0)
    J = torch.where(keep[..., None], J, torch.zeros_like(J))
    return Level(pcl, J, take(inten), keep, keep.sum(-1).to(inten.dtype))


def precompute(pyr: Pyramid, prof: Profile) -> List[Level]:
    return [interest_points(pyr.intensity[lvl], pyr.dx[lvl], pyr.dy[lvl], pyr.depth[lvl], pyr.cams[lvl],
                            prof.min_gradient, prof.max_points >> (2 * lvl)) for lvl in range(prof.levels)]


# ---------------------------------------------------------------------------
# The level solve


def _bilinear(img, u, v, weight_dtype):
    """img (N, H, W), u, v (N, F, P) inside the image; the row weights
    rounded to ``weight_dtype``, as sampling a bf16 image rounds them."""
    N, H, W = img.shape
    u0, v0 = torch.floor(u), torch.floor(v)
    ax, ay = u - u0, v - v0
    wy0, wy1 = (1 - ay).to(weight_dtype).to(u.dtype), ay.to(weight_dtype).to(u.dtype)
    iu, iv = u0.long(), v0.long()
    flat = img.reshape(N, 1, H * W).expand(-1, u.shape[1], -1)

    def at(y, x):
        return flat.gather(2, (y * W + x).clamp(0, H * W - 1))

    left = wy0 * at(iv, iu) + wy1 * at(iv + 1, iu)
    right = wy0 * at(iv, iu + 1) + wy1 * at(iv + 1, iu + 1)
    return (1 - ax) * left + ax * right


def _normal_equations(data: Level, rel, img, cam, x_pred, prof: Profile):
    """A (N, 6, 6), b (N, 6), chi2 (N,), n (N,) summed over the F stacked
    frames, each normalized by its interest points and given the prior."""
    N, F, P = data.mask.shape
    H, W = img.shape[-2:]
    p = (rel[0][:, :, None] @ data.pcl[..., None])[..., 0] + rel[1][:, :, None]
    z_ok = p[..., 2] > 0
    zs = torch.where(z_ok, p[..., 2], torch.ones_like(p[..., 2]))
    fx, fy, cx, cy = (c.view(N, 1, 1) for c in cam)
    u = fx * p[..., 0] / zs + cx
    v = fy * p[..., 1] / zs + cy
    vis = data.mask & z_ok & (u > 1.0) & (u < W - 1.0) & (v > 1.0) & (v < H - 1.0)
    u = torch.where(vis, u, torch.zeros_like(u))
    v = torch.where(vis, v, torch.zeros_like(v))
    r = torch.where(vis, _bilinear(img, u, v, prof.image_dtype) - data.templ, torch.zeros_like(u))
    w = vis.to(r.dtype)
    Jw = data.J * w[..., None]
    A = Jw.transpose(-1, -2) @ data.J
    b = (Jw.transpose(-1, -2) @ r[..., None])[..., 0]
    chi2 = (w * r * r).sum(-1)
    n = data.n
    inv_n = torch.where(n > 1, 1.0 / n.clamp(min=1.0), torch.ones_like(n))
    A, b, chi2 = A * inv_n[..., None, None], b * inv_n[..., None], chi2 * inv_n
    if prof.include_prior:
        eye = torch.eye(6, dtype=A.dtype, device=A.device)
        A = A / (255.0 * 255.0) + prof.prior_weight * eye
        b = b / (255.0 * 255.0) + prof.prior_weight * (se3_log(rel) - x_pred)
    return A.sum(1), b.sum(1), chi2.sum(1), n.sum(1)


def solve_level(data: Level, rel0, img, cam, x_pred, prof: Profile, log: Optional[list] = None):
    """Gauss-Newton over the delta shared by the F frames: rel_f = rel0_f .
    delta. data leaves (N, F, P...), rel0 (N, F), img (N, H, W) f32 values
    of the configuration's image type, cam leaves (N,), x_pred (N, F, 6).
    Returns (rel (N, F), valid (N,))."""
    N, F, _ = data.mask.shape
    dev = img.device
    dt = prof.dtype
    delta = identity((N,), dev, dt)
    chi2_prev = torch.full((N,), float("inf"), device=dev, dtype=dt)
    pushed = torch.zeros(N, dtype=torch.int32, device=dev)
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    evals = torch.zeros(N, dtype=torch.int32, device=dev)
    for _ in range(prof.max_iterations):
        if bool(done.all()):
            break
        live = ~done
        rel = compose(rel0, tuple(x[:, None].expand(-1, F, *x.shape[1:]) for x in delta))
        A, b, chi2, n = _normal_equations(data, rel, img, cam, x_pred, prof)
        L, info = torch.linalg.cholesky_ex(A.float())
        diag = torch.diagonal(L, dim1=-2, dim2=-1)
        logdet = torch.where(info == 0, 2 * torch.log(diag).sum(-1), torch.full_like(diag[:, 0], -float("inf")))
        dx = torch.cholesky_solve(b.float()[..., None], torch.where((info == 0)[:, None, None], L,
                                                                    torch.eye(6, device=dev)))[..., 0].to(dt)
        step = dx.norm(dim=-1)
        abort = (n < 6) | ~torch.isfinite(logdet) | (logdet < _LOG_MIN_DET) | ((pushed > 0) & (chi2 > chi2_prev))
        d_chi2 = (chi2 - chi2_prev).abs()
        conv = (step < prof.min_step_size) | (b.max(-1).values.abs() < prof.min_step_size) | (
            d_chi2 < prof.min_step_size)
        if prof.min_relative_reduction is not None:
            conv = conv | (d_chi2 < prof.min_relative_reduction * chi2.abs())
        conv = conv & (pushed > 0)
        nan = ~torch.isfinite(step)
        take = live & ~abort & ~nan
        evals += live.to(torch.int32)
        delta = _where(take, orthonormalize(compose(delta, se3_exp(-dx))), delta)
        chi2_prev = torch.where(take, chi2, chi2_prev)
        pushed += take.to(torch.int32)
        done = done | abort | nan | conv
    if log is not None:
        H, W = img.shape[-2:]
        log.append({"frames": F, "capacity": data.mask.shape[-1], "height": H, "width": W,
                    "max_iterations": prof.max_iterations, "evals": evals.cpu(),
                    "points": data.mask.sum((1, 2)).cpu()})
    rel = compose(rel0, tuple(x[:, None].expand(-1, F, *x.shape[1:]) for x in delta))
    return rel, pushed > 0


def _image_copy(img, prof: Profile):
    """The values the configuration samples: its image type."""
    return img.to(prof.image_dtype).to(prof.dtype)


def _stack_levels(a: List[Level], b: List[Level]) -> List[Level]:
    return [Level(*(torch.stack([x, y], 1) for x, y in zip(la, lb))) for la, lb in zip(a, b)]


def _align(ref: List[Level], cur: Pyramid, rel, x_pred, prof: Profile, log):
    ok = torch.zeros(rel[1].shape[0], dtype=torch.bool, device=rel[1].device)
    for lvl in range(prof.levels - 1, -1, -1):
        rel, valid = solve_level(ref[lvl], rel, _image_copy(cur.intensity[lvl], prof), cur.cams[lvl], x_pred,
                                 prof, log)
        ok = ok | valid
    return rel, ok


def _frame(images, second, cam, prof: Profile) -> Pyramid:
    inten = sensor_values(images, 0.0, prof.dtype)
    if prof.baseline > 0:
        depth = stereo_depth(inten, sensor_values(second, 0.0, prof.dtype), cam[0], prof)
    else:
        depth = sensor_values(second, prof.depth_step, prof.dtype)
    return frame_pyramid(inten, depth, cam, prof.levels)


def run_suite(images, second, dt: float, cam, prof: Profile, log: Optional[list] = None):
    """Track S sequences of F frames: images and second (S, F, H, W) in the
    sensor's dtypes, cam (fx, fy, cx, cy) floats. Returns the world->camera
    poses (R (S, F, 3, 3), t (S, F, 3)), frame 0 the identity. ``log``
    collects each solve's work, step by step."""
    S, F = images.shape[:2]
    dev = images.device
    cam = tuple(torch.full((S,), float(c), device=dev, dtype=prof.dtype) for c in cam)
    dt_t = torch.full((S,), float(dt), device=dev, dtype=prof.dtype)
    with exact_f32():
        kf = last = precompute(_frame(images[:, 0], second[:, 0], cam, prof), prof)
        pose_kf = pose_last = identity((S,), dev, prof.dtype)
        speed = torch.zeros(S, 6, device=dev, dtype=prof.dtype)
        ctr = torch.zeros(S, dtype=torch.int32, device=dev)
        Rs, ts = [pose_last[0]], [pose_last[1]]
        for k in range(1, F):
            cur = _frame(images[:, k], second[:, k], cam, prof)
            pred = compose(se3_exp(speed * dt_t[:, None]), pose_last)
            cur_data = precompute(cur, prof)
            rel_k = compose(pred, inverse(pose_kf))
            rel_l = compose(pred, inverse(pose_last))
            rel0 = (torch.stack([rel_k[0], rel_l[0]], 1), torch.stack([rel_k[1], rel_l[1]], 1))
            x_pred = torch.stack([se3_log(rel_k), se3_log(rel_l)], 1)
            rel, ok = _align(_stack_levels(kf, last), cur, rel0, x_pred, prof, log)
            aligned = orthonormalize(compose((rel[0][:, 0], rel[1][:, 0]), pose_kf))
            pose = _where(ok, aligned, pred)
            v = se3_log(compose(pose, inverse(pose_last))) / dt_t.clamp(min=1e-6)[:, None]
            speed = torch.where((ok & (dt_t > 0))[:, None], v, torch.zeros_like(v))
            ctr = ctr + 1
            is_kf = (ctr >= prof.kf_period) | (compose(pose, inverse(pose_kf))[1].norm(dim=-1) > prof.kf_max_translation)
            kf = [Level(*(_where(is_kf, c, o) for c, o in zip(lc, lo))) for lc, lo in zip(cur_data, kf)]
            last = cur_data
            pose_kf = _where(is_kf, pose, pose_kf)
            pose_last = pose
            ctr = torch.where(is_kf, torch.zeros_like(ctr), ctr)
            Rs.append(pose[0])
            ts.append(pose[1])
    return torch.stack(Rs, 1), torch.stack(ts, 1)


def run_pairs(ref, cur, cam, prof: Profile, log: Optional[list] = None):
    """Align B independent pairs: ref and cur are (intensity, depth bits)
    (B, H, W) in the sensor's dtypes; each pair starts from the identity with
    a zero prior. Returns rel (R (B, 3, 3), t (B, 3)), current from reference."""
    B = ref[0].shape[0]
    dev = ref[0].device
    cam = tuple(torch.full((B,), float(c), device=dev, dtype=prof.dtype) for c in cam)
    with exact_f32():
        data = [Level(*(x[:, None] for x in lv)) for lv in precompute(_frame(*ref, cam, prof), prof)]
        rel0 = tuple(x[:, None] for x in identity((B,), dev, prof.dtype))
        x_pred = torch.zeros(B, 1, 6, device=dev, dtype=prof.dtype)
        rel, _ = _align(data, _frame(*cur, cam, prof), rel0, x_pred, prof, log)
    return rel[0][:, 0], rel[1][:, 0]
