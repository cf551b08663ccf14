"""The frame build's wrapper on the CPU: its refusals come before any build
of the kernels, CPU tensors take the plain stencils and never load the
kernel library, and sensor images widen there as the scan used to widen
them before `create_frame`. The kernel itself is held against the plain
version on the card (`tests/test_torch_cuda.py`)."""

import numpy as np
import pytest
import torch

from vslam_tpu_torch import _build
from vslam_tpu_torch.core import frame_build
from vslam_tpu_torch.core.camera import Camera
from vslam_tpu_torch.core.frame import create_frame
from vslam_tpu_torch.odometry import sequential
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)


@pytest.fixture
def no_library(monkeypatch):
    """Any load of the kernel libraries fails the test."""

    def refuse():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(_build, "library", refuse)


def _sensor(rng, shape):
    inten = torch.as_tensor(rng.integers(0, 256, shape, dtype=np.uint8))
    counts = rng.integers(0, 65536, shape).astype(np.uint16)  # counts >= 32768 too
    counts[rng.uniform(size=shape) < 0.3] = 0
    return inten, torch.as_tensor(counts.view(np.int16))


def _cam():
    return Camera.create(30.0, 30.0, 12.0, 9.0, device="cpu")


@pytest.mark.parametrize(
    "intensity,depth,n_levels,match",
    [
        (torch.zeros(2, 8, 9, dtype=torch.uint8), torch.zeros(2, 8, 8, dtype=torch.int16), 2, "one shape"),
        (torch.zeros(8, 9, dtype=torch.uint8), torch.zeros(1, 8, 9, dtype=torch.int16), 2, "one shape"),
        (torch.zeros(9, dtype=torch.uint8), torch.zeros(9, dtype=torch.int16), 1, "one shape"),
        (torch.zeros(8, 9, dtype=torch.float64), torch.zeros(8, 9), 2, "intensity: expected uint8 or float32"),
        (torch.zeros(8, 9, dtype=torch.int16), torch.zeros(8, 9), 2, "intensity: expected uint8 or float32"),
        (torch.zeros(8, 9), torch.zeros(8, 9, dtype=torch.uint8), 2, "depth: expected int16"),
        (torch.zeros(8, 9), torch.zeros(8, 9, dtype=torch.int32), 2, "depth: expected int16"),
        (torch.zeros(8, 9), torch.zeros(8, 9, dtype=torch.bfloat16), 2, "depth: expected int16"),
        (torch.zeros(2, 9), torch.zeros(2, 9), 1, "level 0 of 1 is 2x9"),
        (torch.zeros(9, 2), torch.zeros(9, 2), 1, "level 0 of 1 is 9x2"),
        (torch.zeros(5, 9), torch.zeros(5, 9), 3, None),  # 5x9, 3x5, 2x3: fine
        (torch.zeros(5, 9), torch.zeros(5, 9), 4, "level 2 of 4 is 2x3"),  # pyrDown would read 2 rows
        (torch.zeros(8, 9), torch.zeros(8, 9), 0, "n_levels"),
        (torch.zeros(2**16, 2**15, device="meta"), torch.zeros(2**16, 2**15, device="meta"), 1, "2\\^31"),
    ],
)
def test_frame_build_wrapper_refuses_bad_inputs_before_any_build(no_library, intensity, depth, n_levels, match):
    before = frame_build.FRAME_BUILD_LAUNCHES
    # inputs it takes get as far as the device check, still before a build
    with pytest.raises(ValueError, match=match or "expected a CUDA tensor"):
        frame_build._launch(intensity, depth, n_levels)
    assert frame_build.FRAME_BUILD_LAUNCHES == before


def test_frame_build_wrapper_refuses_strided_and_cpu_inputs(no_library):
    inten = torch.zeros(8, 10)
    with pytest.raises(ValueError, match="intensity: expected a CUDA tensor"):
        frame_build._launch(inten, torch.zeros(8, 10), 2)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        frame_build._launch(torch.zeros(8, 10, device="meta"), torch.zeros(8, 10, device="meta"), 2)


def test_create_frame_on_the_cpu_never_loads_the_kernel_library(no_library):
    rng = np.random.default_rng(3)
    inten, depth = _sensor(rng, (2, 13, 17))
    before = frame_build.FRAME_BUILD_LAUNCHES
    frame = create_frame(inten, depth, _cam(), n_levels=3, depth_scale=1.0 / 5000.0)
    assert [t.shape for t in frame.dIy] == [(2, 13, 17), (2, 7, 9), (2, 4, 5)]
    assert all(t.dtype == torch.float32 for t in frame.intensity + frame.depth + frame.dIx + frame.dIy)
    cfg = sequential.SequentialConfig(depth_scale=1.0 / 5000.0)
    cur = sequential._sensor_frame(inten, depth, _cam(), cfg)
    torch.testing.assert_close(cur.depth[2], frame.depth[2], rtol=0, atol=0)
    assert frame_build.FRAME_BUILD_LAUNCHES == before


@pytest.mark.parametrize("depth_scale", [1.0, 1.0 / 5000.0])
def test_sensor_images_widen_in_the_plain_build_as_before_the_frame_build(depth_scale):
    """uint8 + int16 bits into `create_frame` give the frame that f32 images
    widened first (`sequential._sensor_f32(...) * depth_scale`) gave."""
    rng = np.random.default_rng(4)
    inten, depth = _sensor(rng, (3, 11, 14))
    widened = sequential._sensor_f32(depth) * depth_scale
    assert float(widened.max()) >= 32768 * depth_scale  # unsigned, not signed
    a = create_frame(inten, depth, _cam(), n_levels=3, depth_scale=depth_scale)
    b = create_frame(sequential._sensor_f32(inten), widened, _cam(), n_levels=3)
    for x, y in zip(a.intensity + a.depth + a.dIx + a.dIy, b.intensity + b.depth + b.dIx + b.dIy):
        assert torch.equal(x.contiguous().view(torch.int32), y.contiguous().view(torch.int32))


def test_float_sensor_images_narrow_to_f32_in_the_scan_frame(no_library):
    rng = np.random.default_rng(5)
    inten = torch.as_tensor(rng.uniform(0, 255, (1, 9, 12)))  # float64
    depth = torch.as_tensor(rng.uniform(0.5, 3.0, (1, 9, 12)))
    cur = sequential._sensor_frame(inten, depth, _cam(), sequential.SequentialConfig(n_levels=2))
    ref = create_frame(inten.float(), depth.float(), _cam(), n_levels=2)
    assert all(t.dtype == torch.float32 for t in cur.intensity + cur.depth)
    torch.testing.assert_close(cur.dIx[1], ref.dIx[1], rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["uint8+uint16", "uint8+f32", "f64+uint16", "int16+uint8"])
def test_aligner_passes_sensor_images_to_the_frame_build(kind, no_library):
    """`aligner.build_frame`'s images reach `create_frame` as the frame
    build takes them (uint8 intensity, int16 bits of uint16 depth, f32),
    others widened first, integer depth scaled and float depth taken as
    metres; the frame is the one images widened on the host gave."""
    from vslam_tpu_torch.alignment import aligner

    rng = np.random.default_rng(6)
    shape, scale = (10, 13), 1.0 / 5000.0
    inten = {"uint8": rng.integers(0, 256, shape).astype(np.uint8), "f64": rng.uniform(0, 255, shape),
             "int16": rng.integers(0, 256, shape).astype(np.int16)}[kind.split("+")[0]]
    depth = {"uint16": rng.integers(0, 65536, shape).astype(np.uint16), "f32": rng.uniform(0.5, 3, shape)
             .astype(np.float32), "uint8": rng.integers(0, 256, shape).astype(np.uint8)}[kind.split("+")[1]]
    got_i, got_d, got_scale = aligner._sensor_images(inten, depth, "cpu", scale)
    assert got_i.dtype == (torch.uint8 if inten.dtype == np.uint8 else torch.float32)
    assert got_d.dtype == (torch.int16 if depth.dtype == np.uint16 else torch.float32)
    assert got_scale == (1.0 if depth.dtype.kind == "f" else scale)
    frame = create_frame(got_i, got_d, _cam(), n_levels=2, depth_scale=got_scale)
    wide_i = torch.as_tensor(inten.astype(np.float32))
    wide_d = torch.as_tensor(depth.astype(np.float32))
    ref = create_frame(wide_i, wide_d if depth.dtype.kind == "f" else wide_d * scale, _cam(), n_levels=2)
    for x, y in zip(frame.intensity + frame.depth + frame.dIx + frame.dIy, ref.intensity + ref.depth + ref.dIx
                    + ref.dIy):
        assert torch.equal(x.contiguous().view(torch.int32), y.contiguous().view(torch.int32))


def test_level_shapes_halve_rounding_up():
    assert frame_build.level_shapes(480, 640, 3) == [(480, 640), (240, 320), (120, 160)]
    assert frame_build.level_shapes(376, 1241, 4) == [(376, 1241), (188, 621), (94, 311), (47, 156)]
    assert frame_build.level_shapes(5, 7, 3) == [(5, 7), (3, 4), (2, 2)]
