"""Dense inverse-compositional SE(3) image alignment — the hot path.

Port of `vslam_tpu.alignment.ic` (reference `InverseCompositional.cpp`,
`InverseCompositionalStacked.cpp`, `SE3Alignment.cpp`). The JAX package runs
one frame pair per `vmap` lane; here every array carries the pair axis B
explicitly, ahead of the stacked-reference-frame axis F:

    ICLevelData  pcl (B, F, P, 3)  J (B, F, P, 6)  templ, mask (B, F, P)
                 n_constraints (B, F)
    rel0 / rel   SE3 with leaves (B, F, 3, 3), (B, F, 3)
    image_cur    (B, H, W);  cam_cur leaves (B,)

Reference semantics kept: interest points |grad I|^2 >= minGradient^2 on a
fully valid 3x3 depth window (SE3Alignment.cpp:83-94, Warp.cpp:118-133), the
block-stratified fixed-capacity compaction of the JAX package (including
its under-selection: capacity nb * (n_sel // nb)), NE normalization by the
constant interest-point count, the sign-corrected 1/255^2 motion prior and
the analytic 2x6 projection Jacobian (Warp.cpp:166-201).

Samplers: "gather" (plain torch GN, the oracle) and "fused_gn" (the whole
level as one CUDA kernel, `fused_solve.py`), with every loss and scaler of
`solvers.loss`. The "fused" and "mxu" samplers, the per-iteration record for
the visual log and the solver diagnostics are the next slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..core import camera as cam_mod
from ..core import image as img_ops
from ..core import se3
from ..core.camera import Camera
from ..core.frame import Frame
from ..core.se3 import SE3
from ..solvers.gauss_newton import SolverConfig, SolverResult, solve_gauss_newton
from ..solvers.linalg6 import inv_psd
from ..solvers import loss as loss_mod
from ..solvers.loss import LossConfig
from ..solvers.normal_equations import NormalEquations

__all__ = [
    "AlignmentConfig",
    "ICLevelData",
    "normalize_level",
    "precompute_level",
    "precompute_frame",
    "solve_level",
    "align",
]

# row-block height of the compact selection (fixed; the JAX package reads
# VSLAM_COMPACT_BLOCK_ROWS with the same default)
_BLOCK_ROWS = 2


@dataclasses.dataclass(frozen=True)
class AlignmentConfig:
    """Static alignment configuration; same fields and defaults as
    `vslam_tpu.alignment.ic.AlignmentConfig`."""

    min_gradient: float = 30.0
    solver: SolverConfig = SolverConfig(max_iterations=100, min_step_size=1e-11)
    loss: LossConfig = LossConfig("None")
    include_prior: bool = True
    prior_weight: float = 1.0
    interpolation: str = "bilinear"  # or "nearest" (InverseCompositional.cpp:119-120)
    orthonormalize: bool = True
    max_points: int = 32768  # finest-level budget, quartered per level; 0 = dense
    sampler: str = "gather"  # "gather" | "fused_gn" in the port so far
    image_dtype: str = "float32"  # "bfloat16": the kernel samples a bf16 copy
    normalize_intensity: bool = False


def _masked_stats(x: torch.Tensor):
    """(mean, std) over the valid (nonzero) pixels of each image, keepdim
    over the last two axes."""
    valid = x > 0.0
    n = torch.clamp(valid.sum(dim=(-2, -1), keepdim=True), min=1).to(x.dtype)
    zero = torch.zeros_like(x)
    m = torch.sum(torch.where(valid, x, zero), dim=(-2, -1), keepdim=True) / n
    var = torch.sum(torch.where(valid, (x - m) ** 2, zero), dim=(-2, -1), keepdim=True) / n
    return m, torch.sqrt(var)


def _standardize(img: torch.Tensor) -> torch.Tensor:
    """Per-image photometric standardization to mean 128 / spread 64 over
    valid pixels (the exposure-robust mode, ``normalize_intensity``), so a
    global gain and bias between frames cancel out of the residual."""
    x = img.to(torch.float32)
    m, s = _masked_stats(x)
    return ((x - m) / (s + 1e-6) * 64.0 + 128.0).to(img.dtype)


def normalize_level(inten: torch.Tensor, dIx: torch.Tensor, dIy: torch.Tensor):
    """Standardize a reference level's template and scale its gradients by
    the same gain, per image over any leading axes."""
    _, s = _masked_stats(inten.to(torch.float32))
    g = 64.0 / (s + 1e-6)
    return (
        _standardize(inten),
        (dIx.to(torch.float32) * g).to(dIx.dtype),
        (dIy.to(torch.float32) * g).to(dIy.dtype),
    )


class ICLevelData(NamedTuple):
    """Per-(pair, frame, level) interest-point data; see the module doc."""

    pcl: torch.Tensor
    J: torch.Tensor
    templ: torch.Tensor
    mask: torch.Tensor
    n_constraints: torch.Tensor


def _projection_jacobian(p: torch.Tensor, fx, fy) -> torch.Tensor:
    """Analytic d(uv)/d(xi) for uv = proj(exp(xi) p), xi = [rho; phi]
    (reference `Warp.cpp:166-201`). ``p`` (..., 3); returns (..., 2, 6)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    z_safe = torch.where(z > 0, z, torch.ones_like(z))
    zi = 1.0 / z_safe
    zi2 = zi * zi
    zero = torch.zeros_like(x)
    j02 = -x * zi2
    j12 = -y * zi2
    row0 = torch.stack([zi, zero, j02, y * j02, 1.0 - x * j02, -y * zi], dim=-1) * fx[..., None]
    row1 = torch.stack([zero, zi, j12, -1.0 + y * j12, -y * j02, x * zi], dim=-1) * fy[..., None]
    return torch.stack([row0, row1], dim=-2)


def _depth_valid_3x3(depth: torch.Tensor) -> torch.Tensor:
    """A pixel participates only if its whole 3x3 depth window is valid
    (> 0 and finite); image-border pixels fail (Warp.cpp:118-133)."""
    valid = torch.isfinite(depth) & (depth > 0.0)
    H, W = valid.shape[-2:]
    padded = torch.zeros((*valid.shape[:-2], H + 2, W + 2), dtype=torch.bool, device=depth.device)
    padded[..., 1:-1, 1:-1] = valid
    out = torch.ones_like(valid)
    for dy in range(3):
        for dx in range(3):
            out = out & padded[..., dy : dy + H, dx : dx + W]
    return out


def precompute_level(
    intensity: torch.Tensor,
    dIx: torch.Tensor,
    dIy: torch.Tensor,
    depth: torch.Tensor,
    cam: Camera,
    min_gradient: float,
    max_points: int = 0,
) -> ICLevelData:
    """Interest mask, point cloud and steepest-descent rows for one level.

    Images are (*L, H, W) with any leading axes L; camera leaves have a
    prefix of L as their shape. Outputs have leading axes L and a point axis
    P = H * W (dense) or the compact capacity."""
    H, W = intensity.shape[-2:]
    batch = intensity.shape[:-2]
    cam = cam_mod.expand(cam, len(batch))
    if max_points and max_points < H * W:
        return _precompute_compact(intensity, dIx, dIy, depth, cam, min_gradient, max_points)

    dtype, device = intensity.dtype, intensity.device
    grad2 = dIx * dIx + dIy * dIy
    depth_valid = _depth_valid_3x3(depth)
    mask = (grad2 >= min_gradient * min_gradient) & depth_valid

    ys = torch.arange(H, dtype=dtype, device=device)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=dtype, device=device)[None, :].expand(H, W)
    uv = torch.stack([xs, ys], dim=-1).expand(*batch, H, W, 2)
    z = torch.where(depth_valid, depth, torch.zeros_like(depth))
    pix_cam = cam_mod.expand(cam, len(batch) + 2)
    pcl = cam_mod.backproject(pix_cam, uv, z)  # (*L, H, W, 3)

    Jw = _projection_jacobian(pcl, pix_cam.fx, pix_cam.fy)
    J = dIx[..., None] * Jw[..., 0, :] + dIy[..., None] * Jw[..., 1, :]
    mask = mask & (pcl[..., 2] > 0.0)
    J = torch.where(mask[..., None], J, torch.zeros_like(J))
    P = H * W
    mask = mask.reshape(*batch, P)
    return ICLevelData(
        pcl=pcl.reshape(*batch, P, 3),
        J=J.reshape(*batch, P, 6),
        templ=intensity.reshape(*batch, P),
        mask=mask,
        n_constraints=mask.sum(-1).to(dtype),
    )


def _precompute_compact(intensity, dIx, dIy, depth, cam: Camera, min_gradient, n_sel) -> ICLevelData:
    """Interest points gathered into a fixed-capacity list, selecting the
    same set as the JAX package's `_precompute_compact`.

    The image is cut into 2-row blocks; block k keeps kb = n_sel // nb
    (at least 1) of its masked pixels, slot s taking the
    floor(s * count / kb) + 1 -th one in row-major order. Duplicate ranks
    (under-full blocks) and ranks past the count are invalid slots.
    The JAX package finds each rank with a (nb, kb, 2W) one-hot matmul
    over a stack of six planes; here a cumulative count and `searchsorted`
    find the same pixel, and only the selected pixels are read."""
    H, W = intensity.shape[-2:]
    batch = intensity.shape[:-2]
    dtype, device = intensity.dtype, intensity.device
    BR = _BLOCK_ROWS
    nb = -(-H // BR)
    kb = max(n_sel // nb, 1)
    grad2 = dIx * dIx + dIy * dIy
    depth_valid = _depth_valid_3x3(depth)
    mask = (grad2 >= min_gradient * min_gradient) & depth_valid
    if nb * BR != H:  # pad the last block with unmasked rows
        mask = torch.cat([mask, mask.new_zeros(*batch, nb * BR - H, W)], dim=-2)
    M = BR * W
    c = torch.cumsum(mask.reshape(*batch, nb, M).to(torch.int64), dim=-1)  # per-block ranks
    cnt = c[..., -1:]  # (*L, nb, 1) masked population per block
    s_idx = torch.arange(kb, dtype=torch.int64, device=device)
    ranks = torch.div(s_idx * cnt, kb, rounding_mode="floor") + 1  # (*L, nb, kb)
    dup = torch.zeros_like(ranks, dtype=torch.bool)
    dup[..., 1:] = ranks[..., 1:] == ranks[..., :-1]
    exists = cnt >= ranks
    valid = (exists & ~dup).reshape(*batch, nb * kb)
    # the r-th masked pixel is the first position whose running count is r;
    # slots without one read pixel 0 and are zeroed below
    pos = torch.searchsorted(c, ranks)
    block = torch.arange(nb, dtype=torch.int64, device=device)[:, None]
    pix = torch.where(exists, block * M + pos, torch.zeros_like(pos)).reshape(*batch, nb * kb)
    exists = exists.reshape(*batch, nb * kb)

    def take(plane):
        vals = torch.gather(plane.reshape(*batch, H * W).to(torch.float32), -1, pix)
        return torch.where(exists, vals, torch.zeros_like(vals)).to(dtype)

    u, v = (pix % W).to(dtype), (pix // W).to(dtype)
    u = torch.where(exists, u, torch.zeros_like(u))
    v = torch.where(exists, v, torch.zeros_like(v))
    zs = torch.where(valid, take(torch.where(depth_valid, depth, torch.zeros_like(depth))),
                     torch.zeros_like(u))
    gx, gy, templ = take(dIx), take(dIy), take(intensity)

    pt_cam = cam_mod.expand(cam, len(batch) + 1)
    pcl = cam_mod.backproject(pt_cam, torch.stack([u, v], dim=-1), zs)
    Jw = _projection_jacobian(pcl, pt_cam.fx, pt_cam.fy)
    J = gx[..., None] * Jw[..., 0, :] + gy[..., None] * Jw[..., 1, :]
    ok = valid & (pcl[..., 2] > 0.0)
    J = torch.where(ok[..., None], J, torch.zeros_like(J))
    return ICLevelData(pcl=pcl, J=J, templ=templ, mask=ok, n_constraints=ok.sum(-1).to(dtype))


def precompute_frame(frame: Frame, cfg: AlignmentConfig) -> Tuple[ICLevelData, ...]:
    """Per-level interest-point data of a frame, indexed like
    ``frame.intensity`` (0 = finest); leaves keep the frame's leading axes.

    The cacheable half of the aligner: the sequential scan computes a
    frame's data once, when the frame is current, and reuses it as the last
    frame's and, after a switch, the keyframe's (`align(..., ref_data=)`).
    For a fixed config every frame gets the same point count P per level
    (the compact path's fixed capacity), so cached data of different frames
    select against each other with `torch.where`."""
    out = []
    for level in range(len(frame.intensity)):
        budget = cfg.max_points >> (2 * level) if cfg.max_points else 0
        inten, dIx, dIy = frame.intensity[level], frame.dIx[level], frame.dIy[level]
        if cfg.normalize_intensity:
            inten, dIx, dIy = normalize_level(inten, dIx, dIy)
        out.append(precompute_level(inten, dIx, dIy, frame.depth[level], frame.cameras[level],
                                    cfg.min_gradient, max_points=budget))
    return tuple(out)


def _warp_visibility(data: ICLevelData, rel: SE3, image_shape, cam_cur: Camera):
    """Warp + projection + visibility for (B, F, P) points at rel (B, F).
    Returns (u, v, visible), u and v zeroed where invisible."""
    H, W = image_shape
    p_cur = se3.transform_points(SE3(rel.R[..., None, :, :], rel.t[..., None, :]), data.pcl)
    uv, z_ok = cam_mod.project(cam_mod.expand(cam_cur, 3), p_cur)
    u, v = uv[..., 0], uv[..., 1]
    visible = data.mask & z_ok & (u > 1.0) & (u < W - 1.0) & (v > 1.0) & (v < H - 1.0)
    zero = torch.zeros_like(u)
    return torch.where(visible, u, zero), torch.where(visible, v, zero), visible


def _normalize_prior(A, b, chi2, n, rel: SE3, cfg: AlignmentConfig, x_pred) -> NormalEquations:
    """NE normalization by the interest-point count
    (InverseCompositional.cpp:139-143) and the motion prior
    (SE3Alignment.cpp:37-47) with the corrected sign b += (x - x_pred): the
    IC update applies -dx. Leading axes (B, F)."""
    inv_n = torch.where(n > 1, 1.0 / torch.clamp(n, min=1.0), torch.ones_like(n))
    A = A * inv_n[..., None, None]
    b = b * inv_n[..., None]
    chi2 = chi2 * inv_n
    if cfg.include_prior and x_pred is not None:
        normalizer = 1.0 / (255.0 * 255.0)
        x = se3.log(rel)
        eye = torch.eye(6, dtype=A.dtype, device=A.device)
        A = A * normalizer + cfg.prior_weight * eye
        b = b * normalizer + cfg.prior_weight * (x - x_pred)
    return NormalEquations(A, b, chi2, n)


def level_normal_equations(data, rel: SE3, image_cur, cam_cur, cfg, x_pred) -> NormalEquations:
    """Stacked NE, summed over the frame axis
    (InverseCompositionalStacked.cpp:48-62), gather sampling. Returns leaves
    with leading axis B.

    Robust losses scale each (pair, frame) residual vector over its interest
    mask, invisible points entering with r = 0, and weight invisible points
    0 (InverseCompositional.cpp:129-137)."""
    H, W = image_cur.shape[-2:]
    u, v, visible = _warp_visibility(data, rel, (H, W), cam_cur)
    img = image_cur[:, None]  # (B, 1, H, W): one current image per pair
    if cfg.interpolation == "bilinear":
        iwxp = img_ops.bilinear_sample(img.expand(-1, u.shape[1], -1, -1), u, v)
    else:
        iwxp = img_ops.nearest_sample(img.expand(-1, u.shape[1], -1, -1), u, v)
    r = torch.where(visible, iwxp - data.templ, torch.zeros_like(iwxp))
    if cfg.loss.function != "None":
        scale = loss_mod.compute_scale(cfg.loss, r, data.mask)
        r_std = (r - scale.offset[..., None]) / scale.scale[..., None]
        w = torch.where(visible, loss_mod.compute_weights(cfg.loss, r_std), torch.zeros_like(r))
    else:
        w = visible.to(image_cur.dtype)
    Jw = data.J * w[..., None]
    A = Jw.transpose(-1, -2) @ data.J
    b = (Jw.transpose(-1, -2) @ r[..., None])[..., 0]
    chi2 = torch.sum(w * r * r, dim=-1)
    per_frame = _normalize_prior(A, b, chi2, data.n_constraints, rel, cfg, x_pred)
    return NormalEquations(*(x.sum(dim=1) for x in per_frame))


class _LevelState(NamedTuple):
    delta: SE3  # shared compositional update, applied right of every rel0


def _broadcast(g: SE3, like: SE3) -> SE3:
    """(B,) delta -> (B, F) to compose with every stacked frame."""
    F = like.t.shape[1]
    return SE3(g.R[:, None].expand(-1, F, -1, -1), g.t[:, None].expand(-1, F, -1))


def _check_supported(cfg: AlignmentConfig) -> None:
    if cfg.sampler not in ("gather", "fused_gn"):
        raise NotImplementedError(
            f"sampler {cfg.sampler!r} is not ported yet: the 'fused' and 'mxu' samplers "
            "come with the next slice of the port (kernels fused_level_sample, "
            "fused_level_ne and bilinear_sample_mxu_single, ROADMAP.md); use 'gather' "
            "or 'fused_gn'"
        )
    if cfg.loss.function not in ("None", "Huber", "Tukey", "tdistribution"):
        raise ValueError(f"unknown loss {cfg.loss.function!r}")
    if cfg.loss.scaler not in ("reference", "mad", "mean"):
        raise ValueError(f"unknown scaler {cfg.loss.scaler!r}")


def solve_level(data: ICLevelData, rel0: SE3, image_cur, cam_cur: Camera, cfg: AlignmentConfig, x_pred):
    """One coarse-to-fine level: Gauss-Newton over the shared delta
    (rel_f = rel0_f . delta for every stacked frame f). Returns
    (rel (B, F), SolverResult)."""
    _check_supported(cfg)
    if cfg.sampler == "fused_gn":
        from .fused_solve import solve_level_fused

        return solve_level_fused(data, rel0, image_cur, cam_cur, cfg, x_pred)

    def compute_ne(state: _LevelState) -> NormalEquations:
        rel = se3.compose(rel0, _broadcast(state.delta, rel0))
        return level_normal_equations(data, rel, image_cur, cam_cur, cfg, x_pred)

    def update_x(state: _LevelState, dx: torch.Tensor) -> _LevelState:
        # inverse-compositional: delta <- delta . exp(-dx)
        d = se3.compose(state.delta, se3.exp(-dx))
        if cfg.orthonormalize:
            d = se3.orthonormalize(d)
        return _LevelState(d)

    B = rel0.t.shape[0]
    x0 = _LevelState(se3.identity((B,), dtype=image_cur.dtype, device=image_cur.device))
    result = solve_gauss_newton(compute_ne, update_x, x0, n_params=6, config=cfg.solver)
    return se3.compose(rel0, _broadcast(result.x.delta, rel0)), result


def _first_camera(cam: Camera, B: int) -> Camera:
    """Per-pair intrinsics of the first stacked frame (same rig across F)."""
    return Camera(*(c.reshape(B, -1)[:, 0] for c in cam))


def align(
    ref_frames: Optional[Frame],
    cur_frame: Frame,
    rel_init: SE3,
    x_pred,
    cfg: AlignmentConfig,
    ref_data: Optional[Tuple[ICLevelData, ...]] = None,
):
    """Coarse-to-fine alignment of B current frames against F stacked
    reference frames each (SE3Alignment.cpp:106-146).

    ref_frames leaves (B, F, ...); cur_frame leaves (B, ...); rel_init
    (B, F); x_pred (B, F, 6) or None. ``ref_data``, when given, is the
    per-level data of the reference frames (leaves (B, F, ...), 0 = finest,
    e.g. stacked `precompute_frame` results) and replaces their precompute;
    ``ref_frames`` may then be None. Returns (rel (B, F), covariance
    (B, 6, 6) = A^-1 of the last accepted NE of the finest level that
    accepted one (SE3Alignment.cpp:101), valid (B,))."""
    _check_supported(cfg)
    B = rel_init.t.shape[0]
    dtype, device = cur_frame.intensity[0].dtype, cur_frame.intensity[0].device
    rel = rel_init
    cov = torch.eye(6, dtype=dtype, device=device).expand(B, 6, 6).clone()
    valid_any = torch.zeros(B, dtype=torch.bool, device=device)
    n_levels = len(ref_data) if ref_data is not None else len(ref_frames.intensity)
    for level in range(n_levels - 1, -1, -1):
        if ref_data is not None:
            data = ref_data[level]
        else:
            budget = cfg.max_points >> (2 * level) if cfg.max_points else 0
            inten, dIx, dIy = ref_frames.intensity[level], ref_frames.dIx[level], ref_frames.dIy[level]
            if cfg.normalize_intensity:
                inten, dIx, dIy = normalize_level(inten, dIx, dIy)
            data = precompute_level(
                inten, dIx, dIy, ref_frames.depth[level],
                _first_camera(ref_frames.cameras[level], B), cfg.min_gradient, max_points=budget,
            )
        image_cur = cur_frame.intensity[level]
        if cfg.normalize_intensity:
            image_cur = _standardize(image_cur)
        rel, result = solve_level(data, rel, image_cur, cur_frame.cameras[level], cfg, x_pred)
        cov = torch.where(result.valid[:, None, None], inv_psd(result.A), cov)
        valid_any = valid_any | result.valid
    return rel, cov, valid_any
