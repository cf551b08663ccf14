"""Host-facing SE(3) RGB-D aligner (port of `vslam_tpu.alignment.aligner`).

Converts between the host's f64 absolute poses and the device's f32
relative transforms around one coarse-to-fine `ic.align` call (reference
`SE3Alignment.cpp`); one pair, so the pair axis is B = 1. Frames and their
cached per-level data (`ic.precompute_frame`) are unbatched: leaves (H, W)
and (P, ...). It services the visual-log sinks of `utils.log` as the JAX
class does: the SolverGN plot and the per-iteration ImageWarped / Residual
/ Weights images. `align(ref_data=)` solves from the reference frames'
cached data, and `align_build` builds the current frame, precomputes its
data and aligns it in one call, with one wait for the device.

    aligner = RgbdAligner(AlignmentConfig(...))
    pose, cov, ok = aligner.align([kf, last], [kf_pose, last_pose], cur, pred)
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import lie_np
from ..core.frame import Frame, create_frame
from ..core.frame_build import sensor_f32
from ..core.se3 import SE3
from ..utils.log import log_img, log_plt
from ..utils.tree import tree_map
from . import ic
from .ic import AlignmentConfig

__all__ = ["RgbdAligner", "build_frame", "debug_images", "stack_frames", "stack_level_data"]


def stack_frames(frames: Sequence[Frame], dim: int = 0) -> Frame:
    """Stack frames leaf by leaf along a new axis ``dim``."""
    return tree_map(lambda *xs: torch.stack(xs, dim), *frames)


def stack_level_data(ref_datas: Sequence) -> Tuple[ic.ICLevelData, ...]:
    """Per-frame cached level data (unbatched `precompute_frame` tuples)
    stacked on F, with the pair axis B = 1: leaves (1, F, P, ...)."""
    return tuple(tree_map(lambda *xs: torch.stack(xs)[None], *(d[lvl] for d in ref_datas))
                 for lvl in range(len(ref_datas[0])))


def _sensor_images(intensity, depth, device, depth_scale: float):
    """Images in a sensor dtype (numpy or tensors) on ``device`` as the frame
    build takes them, and the depth's metres per unit: uint8 intensity and
    uint16 depth (as int16 bits) travel as they are and widen inside the
    build, other integer images widen to f32 here, float images go as f32;
    integer depth is in counts of ``depth_scale`` metres, float depth in
    metres (the JAX package's `sensor_to_f32`)."""
    from ..odometry.sequential import _upload

    def put(x):
        return x.to(device, non_blocking=True) if isinstance(x, torch.Tensor) else _upload(x, device)

    def kept(x, narrow):
        return x if x.dtype in (narrow, torch.float32) else sensor_f32(x)

    intensity, depth = put(intensity), put(depth)
    scale = 1.0 if depth.is_floating_point() else depth_scale
    return kept(intensity, torch.uint8), kept(depth, torch.int16), scale


def build_frame(intensity, depth, camera, cfg: AlignmentConfig, n_levels: int, depth_scale: float = 1.0):
    """Frame build and alignment precompute of one (H, W) frame in a sensor
    dtype (numpy or tensors, see `_sensor_images`) on the camera's device,
    queued without a wait. Returns (frame, per-level data): the frame's
    cached `ic.precompute_frame` result for its life as a reference."""
    intensity, depth, scale = _sensor_images(intensity, depth, camera.fx.device, depth_scale)
    frame = create_frame(intensity, depth, camera, n_levels=n_levels, depth_scale=scale)
    return frame, ic.precompute_frame(frame, cfg)


def _prep_init(ref_poses, pred_pose, dtype, device):
    """Host f64 -> device f32 initial relative transforms (F,) and prior
    means (F, 6) (SE3Alignment.cpp:112-118)."""
    rels = [lie_np.relative(p, pred_pose) for p in ref_poses]
    rel_init = SE3(
        torch.as_tensor(np.stack([r[:3, :3] for r in rels]), dtype=dtype, device=device),
        torch.as_tensor(np.stack([r[:3, 3] for r in rels]), dtype=dtype, device=device),
    )
    x_pred = torch.as_tensor(np.stack([lie_np.log(r) for r in rels]), dtype=dtype, device=device)
    return rel_init, x_pred


def _finish(rel_out: SE3, cov, valid, ref_pose0: np.ndarray):
    """One fetch, then the f64 re-orthonormalized composition into the
    absolute pose chain (SE3Alignment.cpp:142-143)."""
    flat = torch.cat([rel_out.R.reshape(9), rel_out.t.reshape(3), cov.reshape(36),
                      valid.reshape(1).to(cov.dtype)]).detach().cpu().double().numpy()
    rel0 = np.eye(4)
    rel0[:3, :3] = flat[:9].reshape(3, 3)
    rel0[:3, 3] = flat[9:12]
    u, _, vt = np.linalg.svd(rel0[:3, :3])
    rel0[:3, :3] = u @ vt
    return rel0 @ ref_pose0, flat[12:48].reshape(6, 6), bool(flat[48])


class RgbdAligner:
    def __init__(self, cfg: AlignmentConfig = AlignmentConfig()):
        self.cfg = cfg

    def align(
        self,
        ref_frames: Sequence[Frame],
        ref_poses: Sequence[np.ndarray],  # world->cam 4x4 f64
        cur_frame: Frame,
        pred_pose: np.ndarray,  # predicted world->cam 4x4 f64
        ref_data: Optional[Sequence] = None,  # per-frame ic.precompute_frame tuples
    ) -> Tuple[np.ndarray, np.ndarray, bool]:
        """Coarse-to-fine alignment of ``cur_frame`` against one or more
        reference frames (stacked normal equations). Frames are unbatched
        (leaves (H, W)). Returns (pose world->cam 4x4 f64, covariance 6x6,
        valid).

        When ``ref_data`` carries every reference frame's cached
        `ic.precompute_frame` result, the per-level interest-point
        precompute is skipped (constant for a frame's life in the map,
        InverseCompositional.cpp:50-59) and the frames are stacked on F.

        With an image sink enabled the solve records every evaluated
        iteration and each is replayed into the sinks, coarsest level first
        (InverseCompositional.cpp:149-151); with only the SolverGN sink the
        solver's per-level history is logged (GaussNewton.cpp:100)."""
        img0 = cur_frame.intensity[0]
        rel_init, x_pred = _prep_init(ref_poses, pred_pose, img0.dtype, img0.device)
        cur = tree_map(lambda x: x[None], cur_frame)  # (1, ...)
        init = (SE3(rel_init.R[None], rel_init.t[None]), x_pred[None], self.cfg)
        plt_sink = log_plt("SolverGN")
        img_sinks = [log_img(n) for n in ("ImageWarped", "Residual", "Weights")]
        if any(s.enabled for s in img_sinks) or plt_sink.enabled:
            ref = tree_map(lambda x: x[None], stack_frames(ref_frames))  # (1, F, ...)
            if any(s.enabled for s in img_sinks):
                rel, cov, valid, diag = ic.align(ref, cur, *init, record_iterations=True)
                if plt_sink.enabled:
                    plt_sink.log({k: _host(diag[k]) for k in ("chi2", "step_size", "iterations")})
                self._emit_iteration_logs(ref, cur, diag, img_sinks)
            else:
                rel, cov, valid, diag = ic.align(ref, cur, *init, with_diagnostics=True)
                plt_sink.log({k: _host(v) for k, v in diag.items()})
        elif ref_data is not None and all(d is not None for d in ref_data):
            rel, cov, valid = ic.align(None, cur, *init, ref_data=stack_level_data(ref_data))
        else:
            rel, cov, valid = ic.align(tree_map(lambda x: x[None], stack_frames(ref_frames)), cur, *init)
        return _finish(SE3(rel.R[0, 0], rel.t[0, 0]), cov[0], valid[0], ref_poses[0])

    def align_build(
        self,
        intensity,
        depth,
        camera,
        n_levels: int,
        ref_datas: Sequence,  # per-frame ic.precompute_frame tuples on the device
        ref_poses: Sequence[np.ndarray],
        pred_pose: np.ndarray,
        depth_scale: float = 1.0,
    ):
        """The per-frame step in one call: frame build, precompute and the
        alignment against the cached ``ref_datas``, then one fetch.
        ``intensity`` and ``depth`` are (H, W) images in a sensor dtype
        (numpy or tensors), built on the camera's device (`build_frame`).
        Visual-log sinks are not serviced here; a caller with a sink on
        builds the frame and calls `align`.

        Returns (frame, level_data, pose 4x4 f64, cov 6x6 f64, ok)."""
        frame, level_data = build_frame(intensity, depth, camera, self.cfg, n_levels, depth_scale)
        rel_init, x_pred = _prep_init(ref_poses, pred_pose, torch.float32, camera.fx.device)
        rel, cov, valid = ic.align(None, tree_map(lambda x: x[None], frame),
                                   SE3(rel_init.R[None], rel_init.t[None]), x_pred[None], self.cfg,
                                   ref_data=stack_level_data(ref_datas))
        pose, cov, ok = _finish(SE3(rel.R[0, 0], rel.t[0, 0]), cov[0], valid[0], ref_poses[0])
        return frame, level_data, pose, cov, ok

    def _emit_iteration_logs(self, ref, cur, diag, sinks) -> None:
        """Replay each evaluated GN iteration of each level into the image
        sinks, one `ic.iteration_images` call per iteration; ref and cur
        carry the pair axis B = 1."""
        warped_sink, residual_sink, weights_sink = sinks
        x_log = diag["x_log"]  # (1, L, I, 6)
        n_eval = torch.isfinite(x_log[0, :, :, 0]).sum(dim=1).tolist()
        L = x_log.shape[1]
        for l_idx in range(L):
            level = L - 1 - l_idx  # histories are stored coarsest first
            data = ic.level_data(ref, level, self.cfg)
            rel0 = SE3(diag["rel0_R"][:, l_idx], diag["rel0_t"][:, l_idx])
            for i in range(n_eval[l_idx]):
                out = ic.iteration_images(data, rel0, x_log[:, l_idx, i], cur.intensity[level],
                                          cur.cameras[level], self.cfg)
                warped_sink.log(_host(out["image_warped"]))
                residual_sink.log(_host(out["residual"]))
                weights_sink.log(_host(out["weights"]))


def _host(x: torch.Tensor) -> np.ndarray:
    """One pair's entry (the leading B = 1 axis dropped) as a numpy array."""
    return x[0].detach().cpu().numpy()


def debug_images(ref_frame: Frame, cur_frame: Frame, rel_pose: np.ndarray, level: int = 0):
    """Diagnostic images of a converged alignment at ``rel_pose`` (ref ->
    cur, 4x4), recomputed once over the reference frame's dense grid (the
    reference emits these per GN iteration via LOG_IMG, ImageWarped /
    Residual / Weights, InverseCompositional.cpp:149-151). Frames are
    unbatched. Returns numpy arrays: image_warped (the current image pulled
    onto the reference grid), residual and visible_mask."""
    from ..core import camera as cam_mod
    from ..core import image as img_ops
    from ..core import se3
    from ..core.frame import frame_pcl

    ref_img = ref_frame.intensity[level]
    H, W = ref_img.shape
    pts, valid = frame_pcl(ref_frame, level)
    rel = SE3(torch.as_tensor(rel_pose[:3, :3], dtype=torch.float32, device=ref_img.device),
              torch.as_tensor(rel_pose[:3, 3], dtype=torch.float32, device=ref_img.device))
    uv, zok = cam_mod.project(cur_frame.cameras[level], se3.transform_points(rel, pts.reshape(-1, 3)))
    u, v = uv[..., 0], uv[..., 1]
    vis = valid.reshape(-1) & zok & (u > 1) & (u < W - 1) & (v > 1) & (v < H - 1)
    zero = torch.zeros_like(u)
    samp = img_ops.bilinear_sample(cur_frame.intensity[level], torch.where(vis, u, zero),
                                   torch.where(vis, v, zero))
    warped = torch.where(vis, samp, zero).reshape(H, W)
    vis = vis.reshape(H, W)
    residual = torch.where(vis, warped - ref_img, torch.zeros_like(warped))
    return {"image_warped": warped.cpu().numpy(), "residual": residual.cpu().numpy(),
            "visible_mask": vis.cpu().numpy()}
