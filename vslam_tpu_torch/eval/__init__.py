"""Trajectory evaluation (port of `vslam_tpu.eval`: the metrics, the plots
and the `vslam-run` CLI, `python -m vslam_tpu_torch.eval.evaluate`)."""

from . import metrics
from .metrics import associate, ate_rmse, rpe, summarize

__all__ = ["metrics", "associate", "ate_rmse", "rpe", "summarize"]
