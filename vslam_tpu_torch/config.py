"""Pipeline configuration mirroring the reference's ROS parameter tree.

Port of `vslam_tpu.config`: the same `PipelineConfig` fields, defaults and
dyadic pyramid check, and `load_yaml_config` with the same keys (the
reference's `config/NodeMapping.yaml`, declared in `NodeMapping.cpp:52-65`).
`alignment_config()` returns the port's `AlignmentConfig`. pyyaml is
imported inside `load_yaml_config`, so the package imports without it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .alignment.ic import AlignmentConfig
from .solvers.gauss_newton import SolverConfig
from .solvers.loss import LossConfig

__all__ = ["PipelineConfig", "load_yaml_config"]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    # features.*
    features_min_gradient: float = 30.0
    # pyramid.levels: the reference's scale list [1.0, 0.5, 0.25]; only its
    # size is free (NodeMapping.cpp:226), the values must be dyadic
    pyramid_scales: Tuple[float, ...] = (1.0, 0.5, 0.25)
    # solver.*
    solver_max_iterations: int = 100
    solver_min_step_size: float = 1e-11
    # stop when the relative chi2 improvement drops below this (the f32
    # production profile); None = strict reference parity
    solver_min_relative_reduction: Optional[float] = 1e-4
    # loss.*
    loss_function: str = "None"  # None | Tukey | Huber | tdistribution
    loss_huber_c: float = 1.43
    loss_tdistribution_v: float = 5.0
    # prediction.*
    prediction_model: str = "ConstantMotion"  # NoMotion | ConstantMotion | Kalman
    # keyframe_selection.*
    keyframe_selection_method: str = "idx"  # idx | visible_map
    keyframe_selection_idx_period: int = 5
    keyframe_selection_min_visible_points: int = 50
    keyframe_selection_max_translation: float = 0.2
    # odometry behavior (OdometryRgbd ctor, Odometry.h:46-60)
    include_key_frame: bool = True
    track_key_frame: bool = False
    include_prior: bool = True
    interpolation: str = "bilinear"  # bilinear | nearest (reference parity)
    # metres = raw * depth_scale for integer depth (TUM uint16 counts),
    # widened on the device
    depth_scale: float = 1.0 / 5000.0
    # interest-point budget per frame at the finest level; 0 / 32768 = all
    # points (dense); the production tracking profile uses 2048
    features_max_points: int = 32768
    # gather | mxu | fused | fused_gn (the whole-level CUDA kernel)
    sampler: str = "gather"
    image_dtype: str = "float32"  # bfloat16: the kernels sample a bf16 copy
    normalize_intensity: bool = False
    # SLAM backend (features/, ba/: not ported yet)
    enable_mapping: bool = False
    ba_max_iterations: int = 50
    ba_pose_write_back: str = "gated"
    # loop closure and the global pose graph (odometry/graph_backend.py: not
    # ported yet)
    enable_loop_closure: bool = False
    # log.image.<Name>.show / log.plot.<Name>.show (NodeMapping.cpp:125-135)
    log_image_enabled: Tuple[str, ...] = ()
    log_plot_enabled: Tuple[str, ...] = ()
    # the live viewer's port (viz/live.py: not ported yet); None = off
    live_viz_port: Optional[int] = None

    def __post_init__(self):
        scales = tuple(float(s) for s in self.pyramid_scales)
        if not scales:
            raise ValueError("pyramid_scales must be non-empty")
        want = tuple(1.0 / (2**i) for i in range(len(scales)))
        if tuple(sorted(scales, reverse=True)) != want:
            raise ValueError(
                f"pyramid_scales must be dyadic (1, 0.5, 0.25, ...), got {scales} — "
                "the reference's pyramid is cv::buildPyramid (dyadic) and only the "
                "level count is free (NodeMapping.cpp:226)"
            )
        object.__setattr__(self, "pyramid_scales", scales)

    @property
    def pyramid_levels(self) -> int:
        return len(self.pyramid_scales)

    def alignment_config(self) -> AlignmentConfig:
        return AlignmentConfig(
            min_gradient=self.features_min_gradient,
            solver=SolverConfig(
                max_iterations=self.solver_max_iterations,
                min_step_size=self.solver_min_step_size,
                min_relative_reduction=self.solver_min_relative_reduction,
            ),
            loss=LossConfig(
                function=self.loss_function,
                huber_c=self.loss_huber_c,
                tdistribution_v=self.loss_tdistribution_v,
            ),
            include_prior=self.include_prior,
            interpolation=self.interpolation,
            max_points=self.features_max_points,
            sampler=self.sampler,
            image_dtype=self.image_dtype,
            normalize_intensity=self.normalize_intensity,
        )


def _flatten(d, prefix=""):
    out = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


# flat YAML key -> (PipelineConfig field, type)
_KEYS = {
    "features.min_gradient": ("features_min_gradient", float),
    "solver.max_iterations": ("solver_max_iterations", int),
    "solver.min_step_size": ("solver_min_step_size", float),
    "loss.function": ("loss_function", str),
    "loss.huber.c": ("loss_huber_c", float),
    "loss.tdistribution.v": ("loss_tdistribution_v", float),
    "prediction.model": ("prediction_model", str),
    "keyframe_selection.method": ("keyframe_selection_method", str),
    "keyframe_selection.idx.period": ("keyframe_selection_idx_period", int),
    "keyframe_selection.visible_map.min_visible_points": ("keyframe_selection_min_visible_points", int),
    "keyframe_selection.visible_map.max_translation": ("keyframe_selection_max_translation", float),
    "odometry.include_key_frame": ("include_key_frame", bool),
    "odometry.track_key_frame": ("track_key_frame", bool),
    "odometry.include_prior": ("include_prior", bool),
    "mapping.enabled": ("enable_mapping", bool),
    "mapping.loop_closure": ("enable_loop_closure", bool),
}


def load_yaml_config(path: str) -> PipelineConfig:
    """Build a PipelineConfig from a reference-style YAML parameter file."""
    try:
        import yaml  # type: ignore
    except ImportError as exc:  # pragma: no cover
        raise RuntimeError("pyyaml not available; construct PipelineConfig directly") from exc
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    flat = _flatten(raw)
    kw = {field: kind(flat[key]) for key, (field, kind) in _KEYS.items() if key in flat}
    if "pyramid.levels" in flat:
        levels = flat["pyramid.levels"]
        if isinstance(levels, list):
            kw["pyramid_scales"] = tuple(float(s) for s in levels)
        else:  # plain level count
            kw["pyramid_scales"] = tuple(1.0 / (2**i) for i in range(int(levels)))
    # visual-log sinks: log.image.<Name>.show / log.plot.<Name>.show
    for section, field in (("image", "log_image_enabled"), ("plot", "log_plot_enabled")):
        names = [str(name) for name, sub in ((raw.get("log", {}) or {}).get(section, {}) or {}).items()
                 if isinstance(sub, dict) and sub.get("show")]
        if names:
            kw[field] = tuple(sorted(names))
    return PipelineConfig(**kw)
