"""The port's `PipelineConfig` and `load_yaml_config` against the JAX
package's: the same fields and defaults, the same dataclasses from the
repository's two YAML files, the same alignment config field by field, and
the dyadic pyramid check."""

import dataclasses
import pathlib

import pytest

from vslam_tpu import config as jconfig
from vslam_tpu_torch import config as tconfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"


def test_fields_and_defaults_equal_jax():
    j_fields = [(f.name, f.default) for f in dataclasses.fields(jconfig.PipelineConfig)]
    t_fields = [(f.name, f.default) for f in dataclasses.fields(tconfig.PipelineConfig)]
    assert t_fields == j_fields
    assert tconfig.PipelineConfig().pyramid_levels == jconfig.PipelineConfig().pyramid_levels == 3


@pytest.mark.parametrize("name", ["node_mapping.yaml", "node_rgbd_alignment.yaml"])
def test_yaml_loads_the_same_dataclass(name):
    j = jconfig.load_yaml_config(str(CONFIGS / name))
    t = tconfig.load_yaml_config(str(CONFIGS / name))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_yaml_keys_and_log_sinks(tmp_path):
    """Every key the loaders read, the plain level count and the log
    sinks' show flags."""
    path = tmp_path / "all.yaml"
    path.write_text(
        "features: {min_gradient: 12}\npyramid: {levels: 4}\n"
        "solver: {max_iterations: 7, min_step_size: 1.0e-9}\n"
        "loss: {function: Huber, huber: {c: 2.0}, tdistribution: {v: 3.0}}\n"
        "prediction: {model: Kalman}\n"
        "keyframe_selection: {method: visible_map, idx: {period: 3}, "
        "visible_map: {min_visible_points: 9, max_translation: 0.1}}\n"
        "odometry: {include_key_frame: false, track_key_frame: true, include_prior: false}\n"
        "mapping: {enabled: true, loop_closure: true}\n"
        "log: {image: {Residual: {show: true}, ImageWarped: {show: false}}, plot: {SolverGN: {show: true}}}\n")
    j = jconfig.load_yaml_config(str(path))
    t = tconfig.load_yaml_config(str(path))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.pyramid_levels == 4 and t.log_image_enabled == ("Residual",) and t.enable_loop_closure


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"loss_function": "Tukey", "sampler": "fused_gn", "image_dtype": "bfloat16",
          "features_max_points": 2048, "solver_min_relative_reduction": None, "include_prior": False,
          "interpolation": "nearest", "normalize_intensity": True}],
    ids=["defaults", "production"],
)
def test_alignment_config_equals_jax_field_by_field(kwargs):
    j = jconfig.PipelineConfig(**kwargs).alignment_config()
    t = tconfig.PipelineConfig(**kwargs).alignment_config()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.solver._min_gradient == j.solver._min_gradient


@pytest.mark.parametrize("scales", [(1.0, 0.6), (1.0, 0.25), (), (0.5, 0.25)])
def test_dyadic_check_raises(scales):
    with pytest.raises(ValueError, match="pyramid_scales"):
        tconfig.PipelineConfig(pyramid_scales=scales)
    with pytest.raises(ValueError, match="pyramid_scales"):
        jconfig.PipelineConfig(pyramid_scales=scales)
    assert tconfig.PipelineConfig(pyramid_scales=(0.5, 1.0)).pyramid_scales == (0.5, 1.0)
