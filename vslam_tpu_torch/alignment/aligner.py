"""Host-facing SE(3) RGB-D aligner (port of `vslam_tpu.alignment.aligner`).

Converts between the host's f64 absolute poses and the device's f32
relative transforms around one coarse-to-fine `ic.align` call (reference
`SE3Alignment.cpp`); one pair, so the pair axis is B = 1. It services the
visual-log sinks of `utils.log` as the JAX class does: the SolverGN plot
and the per-iteration ImageWarped / Residual / Weights images. The cached
reference data and the fused build-and-align step of the JAX class are not
ported yet.

    aligner = RgbdAligner(AlignmentConfig(...))
    pose, cov, ok = aligner.align([kf, last], [kf_pose, last_pose], cur, pred)
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..core import lie_np
from ..core.frame import Frame
from ..core.se3 import SE3
from ..utils.log import log_img, log_plt
from ..utils.tree import tree_map
from . import ic
from .ic import AlignmentConfig

__all__ = ["RgbdAligner", "stack_frames"]


def stack_frames(frames: Sequence[Frame], dim: int = 0) -> Frame:
    """Stack frames leaf by leaf along a new axis ``dim``."""
    return tree_map(lambda *xs: torch.stack(xs, dim), *frames)


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
    rel0 = np.eye(4)
    rel0[:3, :3] = rel_out.R.detach().cpu().double().numpy()
    rel0[:3, 3] = rel_out.t.detach().cpu().double().numpy()
    u, _, vt = np.linalg.svd(rel0[:3, :3])
    rel0[:3, :3] = u @ vt
    return rel0 @ ref_pose0, cov.detach().cpu().double().numpy(), bool(valid)


class RgbdAligner:
    def __init__(self, cfg: AlignmentConfig = AlignmentConfig()):
        self.cfg = cfg

    def align(
        self,
        ref_frames: Sequence[Frame],
        ref_poses: Sequence[np.ndarray],  # world->cam 4x4 f64
        cur_frame: Frame,
        pred_pose: np.ndarray,  # predicted world->cam 4x4 f64
    ) -> Tuple[np.ndarray, np.ndarray, bool]:
        """Coarse-to-fine alignment of ``cur_frame`` against one or more
        reference frames (stacked normal equations). Frames are unbatched
        (leaves (H, W)). Returns (pose world->cam 4x4 f64, covariance 6x6,
        valid).

        With an image sink enabled the solve records every evaluated
        iteration and each is replayed into the sinks, coarsest level first
        (InverseCompositional.cpp:149-151); with only the SolverGN sink the
        solver's per-level history is logged (GaussNewton.cpp:100)."""
        img0 = cur_frame.intensity[0]
        rel_init, x_pred = _prep_init(ref_poses, pred_pose, img0.dtype, img0.device)
        ref = tree_map(lambda x: x[None], stack_frames(ref_frames))  # (1, F, ...)
        cur = tree_map(lambda x: x[None], cur_frame)  # (1, ...)
        args = (ref, cur, SE3(rel_init.R[None], rel_init.t[None]), x_pred[None], self.cfg)
        plt_sink = log_plt("SolverGN")
        img_sinks = [log_img(n) for n in ("ImageWarped", "Residual", "Weights")]
        if any(s.enabled for s in img_sinks):
            rel, cov, valid, diag = ic.align(*args, record_iterations=True)
            if plt_sink.enabled:
                plt_sink.log({k: _host(diag[k]) for k in ("chi2", "step_size", "iterations")})
            self._emit_iteration_logs(ref, cur, diag, img_sinks)
        elif plt_sink.enabled:
            rel, cov, valid, diag = ic.align(*args, with_diagnostics=True)
            plt_sink.log({k: _host(v) for k, v in diag.items()})
        else:
            rel, cov, valid = ic.align(*args)
        return _finish(SE3(rel.R[0, 0], rel.t[0, 0]), cov[0], valid[0], ref_poses[0])

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
