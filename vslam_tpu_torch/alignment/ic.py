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

Samplers, with every loss and scaler of `solvers.loss`:

* "gather": plain torch sampling per GN iteration, the oracle;
* "fused": per iteration one CUDA kernel, `fused_ne.fused_level_ne` (the
  quadratic loss) or `fused_ne.fused_level_sample` followed by the robust
  scale and weights in torch;
* "mxu": per iteration `pallas_kernels.bilinear_sample_mxu` on the f32 image
  (bilinear whatever `interpolation` says);
* "fused_gn": the whole level as one CUDA kernel (`fused_solve.py`); when
  the iterations are recorded it runs the per-iteration loop instead, with
  `fused_level_sample` for a robust loss.

`align(with_diagnostics=, record_iterations=)` returns the solver's
per-level history (the SolverGN plot payload) and the recorded state of
every evaluated iteration, which `iteration_images` replays into the
visual-log images.
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
from ..utils import timer

__all__ = [
    "AlignmentConfig",
    "ICLevelData",
    "normalize_level",
    "precompute_level",
    "precompute_frame",
    "level_normal_equations",
    "solve_level",
    "iteration_images",
    "align",
]

_SAMPLERS = ("gather", "fused", "mxu", "fused_gn")

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
    sampler: str = "gather"  # "gather" | "fused" | "mxu" | "fused_gn"
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
    P = H * W (dense) or the compact capacity. The span "align.precompute"."""
    with timer.scope("align.precompute"):
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


def _use_fused(cfg: AlignmentConfig) -> bool:
    return cfg.sampler == "fused" and cfg.loss.function == "None"


def _use_fused_sampling(cfg: AlignmentConfig) -> bool:
    """Robust losses with a kernel sampler: the kernel samples, torch
    computes the residual scale (a statistic over the frame) and the
    weights."""
    return cfg.sampler in ("fused", "fused_gn") and cfg.loss.function != "None"


def _sum_frames(per_frame: NormalEquations) -> NormalEquations:
    return NormalEquations(*(x.sum(dim=1) for x in per_frame))


def level_normal_equations(data, rel: SE3, image_cur, cam_cur, cfg, x_pred) -> NormalEquations:
    """Stacked NE, summed over the frame axis
    (InverseCompositionalStacked.cpp:48-62). Returns leaves with leading
    axis B. ``image_cur`` is the sampled image: `solve_level` hands the
    "fused" samplers a bf16 copy in "bfloat16" mode.

    The samplers in the JAX package's order: the fused NE kernel (quadratic
    loss), the fused sampling kernel (robust losses), the mxu kernel, the
    torch gather. Robust losses scale each (pair, frame) residual vector
    over its interest mask, invisible points entering with r = 0, and
    weight invisible points 0 (InverseCompositional.cpp:129-137); that
    math stays in f32 when the kernel sampled a bf16 image."""
    if _use_fused(cfg):
        from .fused_ne import fused_level_ne

        A, b, chi2, _ = fused_level_ne(data, rel, image_cur, cam_cur, cfg.interpolation)
        return _sum_frames(_normalize_prior(A, b, chi2, data.n_constraints, rel, cfg, x_pred))
    if _use_fused_sampling(cfg):
        from .fused_ne import fused_level_sample

        sampled = fused_level_sample(data, rel, image_cur, cam_cur, cfg.interpolation)
    elif cfg.sampler == "mxu":
        from .pallas_kernels import bilinear_sample_mxu

        B, F, P = data.mask.shape
        u, v, visible = _warp_visibility(data, rel, image_cur.shape[-2:], cam_cur)
        iwxp = bilinear_sample_mxu(image_cur, u.reshape(B, F * P), v.reshape(B, F * P))
        sampled = iwxp.reshape(B, F, P), visible
    else:
        sampled = None
    return _gather_normal_equations(data, rel, image_cur, cam_cur, cfg, x_pred, sampled)


def _gather_normal_equations(data, rel: SE3, image_cur, cam_cur, cfg, x_pred, sampled=None):
    """The torch NE from (iwxp, visible) (B, F, P): ``sampled`` from a
    kernel, or gathered here."""
    if sampled is None:
        u, v, visible = _warp_visibility(data, rel, image_cur.shape[-2:], cam_cur)
        img = image_cur[:, None].expand(-1, u.shape[1], -1, -1)  # one current image per pair
        sample = img_ops.bilinear_sample if cfg.interpolation == "bilinear" else img_ops.nearest_sample
        iwxp = sample(img, u, v)
    else:
        iwxp, visible = sampled
    r = torch.where(visible, iwxp - data.templ, torch.zeros_like(data.templ))
    if cfg.loss.function != "None":
        w = _robust_weights(r, data.mask, visible, cfg)
    else:
        w = visible.to(r.dtype)
    Jw = data.J * w[..., None]
    A = Jw.transpose(-1, -2) @ data.J
    b = (Jw.transpose(-1, -2) @ r[..., None])[..., 0]
    chi2 = torch.sum(w * r * r, dim=-1)
    return _sum_frames(_normalize_prior(A, b, chi2, data.n_constraints, rel, cfg, x_pred))


def _robust_weights(r, mask, visible, cfg: AlignmentConfig):
    """M-estimator weights of r (B, F, P) under the scale of each (pair,
    frame) over its interest mask; 0 where invisible."""
    scale = loss_mod.compute_scale(cfg.loss, r, mask)
    r_std = (r - scale.offset[..., None]) / scale.scale[..., None]
    return torch.where(visible, loss_mod.compute_weights(cfg.loss, r_std), torch.zeros_like(r))


class _LevelState(NamedTuple):
    delta: SE3  # shared compositional update, applied right of every rel0


def _broadcast(g: SE3, like: SE3) -> SE3:
    """(B,) delta -> (B, F) to compose with every stacked frame."""
    F = like.t.shape[1]
    return SE3(g.R[:, None].expand(-1, F, -1, -1), g.t[:, None].expand(-1, F, -1))


def _check_supported(cfg: AlignmentConfig) -> None:
    if cfg.sampler not in _SAMPLERS:
        raise ValueError(f"unknown sampler {cfg.sampler!r}: one of {', '.join(_SAMPLERS)}")
    if cfg.loss.function not in ("None", "Huber", "Tukey", "tdistribution"):
        raise ValueError(f"unknown loss {cfg.loss.function!r}")
    if cfg.loss.scaler not in ("reference", "mad", "mean"):
        raise ValueError(f"unknown scaler {cfg.loss.scaler!r}")


def solve_level(data: ICLevelData, rel0: SE3, image_cur, cam_cur: Camera, cfg: AlignmentConfig, x_pred,
                record_iterations: bool = False):
    """One coarse-to-fine level: Gauss-Newton over the shared delta
    (rel_f = rel0_f . delta for every stacked frame f). Returns
    (rel (B, F), SolverResult).

    ``record_iterations`` records log(delta) per evaluated iteration
    (`SolverResult.x_history`) for the visual-log replay; the whole-level
    kernel keeps no per-iteration state, so "fused_gn" then runs the
    per-iteration loop."""
    _check_supported(cfg)
    if cfg.sampler == "fused_gn" and not record_iterations:
        from .fused_solve import solve_level_fused

        return solve_level_fused(data, rel0, image_cur, cam_cur, cfg, x_pred)

    # the sampled image, once per level outside the loop: a bf16 copy for
    # the fused kernels in "bfloat16" mode, row-major for every kernel
    img_solve = image_cur
    if (_use_fused(cfg) or _use_fused_sampling(cfg)) and cfg.image_dtype == "bfloat16":
        img_solve = image_cur.to(torch.bfloat16)
    img_solve = img_solve.contiguous()

    def compute_ne(state: _LevelState) -> NormalEquations:
        rel = se3.compose(rel0, _broadcast(state.delta, rel0))
        return level_normal_equations(data, rel, img_solve, cam_cur, cfg, x_pred)

    def update_x(state: _LevelState, dx: torch.Tensor) -> _LevelState:
        # inverse-compositional: delta <- delta . exp(-dx)
        d = se3.compose(state.delta, se3.exp(-dx))
        if cfg.orthonormalize:
            d = se3.orthonormalize(d)
        return _LevelState(d)

    B = rel0.t.shape[0]
    x0 = _LevelState(se3.identity((B,), dtype=image_cur.dtype, device=image_cur.device))
    encode_x = (lambda s: se3.log(s.delta)) if record_iterations else None
    result = solve_gauss_newton(compute_ne, update_x, x0, n_params=6, config=cfg.solver,
                                encode_x=encode_x)
    return se3.compose(rel0, _broadcast(result.x.delta, rel0)), result


def iteration_images(data: ICLevelData, rel0: SE3, x_it: torch.Tensor, image_cur, cam_cur: Camera,
                     cfg: Optional[AlignmentConfig] = None):
    """Replay one recorded GN iteration into visual-log images (the
    reference logs ImageWarped / Residual / Weights inside every iteration,
    InverseCompositional.cpp:149-151).

    data leaves (B, F, ...) of one level; rel0 (B, F) the level's entry
    pose; x_it (B, 6) the recorded log(delta); image_cur (B, H, W). The
    residual pass is re-evaluated at rel0 . exp(x_it) with the solver's
    sampling mode. Returns a dict of (B, F, H, W) images: image_warped,
    residual and weights (the robust weights when ``cfg`` has a loss, else
    the visibility), scattered to the reference frames' interest pixels
    (background 0)."""
    H, W = image_cur.shape[-2:]
    if cfg is not None and cfg.normalize_intensity:
        image_cur = _standardize(image_cur)
    rel = se3.compose(rel0, _broadcast(se3.exp(x_it), rel0))
    u, v, visible = _warp_visibility(data, rel, (H, W), cam_cur)
    nearest = cfg is not None and cfg.interpolation != "bilinear"
    sample = img_ops.nearest_sample if nearest else img_ops.bilinear_sample
    iwxp = sample(image_cur[:, None].expand(-1, u.shape[1], -1, -1), u, v)
    r = torch.where(visible, iwxp - data.templ, torch.zeros_like(iwxp))
    if cfg is not None and cfg.loss.function != "None":
        weights = _robust_weights(r, data.mask, visible, cfg)
    else:
        weights = visible.to(image_cur.dtype)

    # template pixel of each interest point (pcl is in the reference camera
    # frame; the same rig as the current frame at this level)
    uv_t, _ = cam_mod.project(cam_mod.expand(cam_cur, 3), data.pcl)
    ui = torch.clamp(torch.round(uv_t[..., 0]), 0, W - 1).long()
    vi = torch.clamp(torch.round(uv_t[..., 1]), 0, H - 1).long()
    B, F, P = data.mask.shape
    bi = torch.arange(B, device=ui.device)[:, None, None].expand(B, F, P)
    fi = torch.arange(F, device=ui.device)[None, :, None].expand(B, F, P)

    def scatter(vals, mask):
        # masked-out points all land on pixel (0, 0), which is zeroed after
        img = torch.zeros(B, F, H, W, dtype=vals.dtype, device=vals.device)
        idx = (bi, fi, torch.where(mask, vi, 0), torch.where(mask, ui, 0))
        img.index_put_(idx, torch.where(mask, vals, torch.zeros_like(vals)), accumulate=True)
        img[..., 0, 0] = 0.0
        return img

    return {
        "image_warped": scatter(iwxp, visible),
        "residual": scatter(r, visible),
        "weights": scatter(weights, data.mask),
    }


def _first_camera(cam: Camera, B: int) -> Camera:
    """Per-pair intrinsics of the first stacked frame (same rig across F)."""
    return Camera(*(c.reshape(B, -1)[:, 0] for c in cam))


def level_data(ref_frames: Frame, level: int, cfg: AlignmentConfig) -> ICLevelData:
    """The interest-point data of the stacked reference frames (leaves
    (B, F, ...)) at one level, as `align` computes it."""
    B = ref_frames.intensity[level].shape[0]
    budget = cfg.max_points >> (2 * level) if cfg.max_points else 0
    inten, dIx, dIy = ref_frames.intensity[level], ref_frames.dIx[level], ref_frames.dIy[level]
    if cfg.normalize_intensity:
        inten, dIx, dIy = normalize_level(inten, dIx, dIy)
    return precompute_level(inten, dIx, dIy, ref_frames.depth[level],
                            _first_camera(ref_frames.cameras[level], B), cfg.min_gradient,
                            max_points=budget)


def align(
    ref_frames: Optional[Frame],
    cur_frame: Frame,
    rel_init: SE3,
    x_pred,
    cfg: AlignmentConfig,
    ref_data: Optional[Tuple[ICLevelData, ...]] = None,
    with_diagnostics: bool = False,
    record_iterations: bool = False,
):
    """Coarse-to-fine alignment of B current frames against F stacked
    reference frames each (SE3Alignment.cpp:106-146).

    ref_frames leaves (B, F, ...); cur_frame leaves (B, ...); rel_init
    (B, F); x_pred (B, F, 6) or None. ``ref_data``, when given, is the
    per-level data of the reference frames (leaves (B, F, ...), 0 = finest,
    e.g. stacked `precompute_frame` results) and replaces their precompute;
    ``ref_frames`` may then be None. Returns (rel (B, F), covariance
    (B, 6, 6) = A^-1 of the last accepted NE of the finest level that
    accepted one (SE3Alignment.cpp:101), valid (B,)).

    ``with_diagnostics`` or ``record_iterations`` appends a dict of the
    per-level solver history, coarsest level first (the solve order; the
    LOG_PLT("SolverGN") payload, GaussNewton.cpp:100): chi2 and step_size
    (B, L, max_iterations), iterations (B, L). ``record_iterations`` adds
    the visual-log trace: x_log (B, L, max_iterations, 6), log(delta) at
    each evaluated iteration (NaN after), and each level's entry pose
    rel0_R (B, L, F, 3, 3), rel0_t (B, L, F, 3).

    Spans "align" around it all and "align.solve" around each level's solve;
    counters "align.gn_solves" (B a level) and "align.gn_iterations" (each
    level's accepted iterations, a device tensor, kept while a profiler
    records)."""
    with timer.scope("align"):
        _check_supported(cfg)
        B = rel_init.t.shape[0]
        dtype, device = cur_frame.intensity[0].dtype, cur_frame.intensity[0].device
        rel = rel_init
        cov = torch.eye(6, dtype=dtype, device=device).expand(B, 6, 6).clone()
        valid_any = torch.zeros(B, dtype=torch.bool, device=device)
        hist = {k: [] for k in ("chi2", "step_size", "iterations", "x_log", "rel0_R", "rel0_t")}
        n_levels = len(ref_data) if ref_data is not None else len(ref_frames.intensity)
        for level in range(n_levels - 1, -1, -1):
            data = ref_data[level] if ref_data is not None else level_data(ref_frames, level, cfg)
            image_cur = cur_frame.intensity[level]
            if cfg.normalize_intensity:
                image_cur = _standardize(image_cur)
            rel0 = rel
            with timer.scope("align.solve"):
                rel, result = solve_level(data, rel0, image_cur, cur_frame.cameras[level], cfg, x_pred,
                                          record_iterations=record_iterations)
            timer.count("align.gn_solves", B)
            timer.count("align.gn_iterations", result.iterations)
            cov = torch.where(result.valid[:, None, None], inv_psd(result.A), cov)
            valid_any = valid_any | result.valid
            hist["chi2"].append(result.chi2_history)
            hist["step_size"].append(result.step_history)
            hist["iterations"].append(result.iterations)
            if record_iterations:
                hist["x_log"].append(result.x_history)
                hist["rel0_R"].append(rel0.R)
                hist["rel0_t"].append(rel0.t)
        if not (with_diagnostics or record_iterations):
            return rel, cov, valid_any
        diag = {k: torch.stack(v, dim=1) for k, v in hist.items() if v}
        return rel, cov, valid_any, diag
