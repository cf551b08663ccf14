"""Guards of the port's boundaries: it (its examples too) imports without
JAX, its kernel wrappers never fall back silently, its entry points (the
multi-GPU ones and the examples too) default to the card, its public
surface covers the JAX package's, its console script resolves, and
chip_smoke's last line keeps the contract's keys."""

import ast
import dataclasses
import importlib
import importlib.util
import inspect
import os
import re
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from vslam_tpu.alignment.ic import AlignmentConfig as JAlignmentConfig
from vslam_tpu.solvers import LossConfig as JLossConfig
from vslam_tpu.solvers import SolverConfig as JSolverConfig
from vslam_tpu_torch import _build, interop
from vslam_tpu_torch.alignment import fused_ne, fused_solve, pallas_kernels
from vslam_tpu_torch.alignment import ic as tic
from vslam_tpu_torch.alignment.ic import ICLevelData
from vslam_tpu_torch.core import se3
from vslam_tpu_torch.core.camera import Camera
from vslam_tpu_torch.core.se3 import SE3
from vslam_tpu_torch.eval import evaluate
from vslam_tpu_torch.kalman import ekf_se3
from vslam_tpu_torch.config import PipelineConfig
from vslam_tpu_torch.odometry.pipeline import OdometryPipeline
from vslam_tpu_torch.alignment.fa_se3 import RgbdAlignerFa
from vslam_tpu_torch.alignment.icp import IcpAligner
from vslam_tpu_torch.io.kitti import KittiDataset
from vslam_tpu_torch.io import synthetic
from vslam_tpu_torch.odometry.sequential import SequentialConfig, SequentialOdometry, stage_stream
from vslam_tpu_torch.odometry.sequential_mapping import ChunkMappingBackend
from vslam_tpu_torch.parallel import batched, multihost
from vslam_tpu_torch.parallel import mesh as mesh_lib
from vslam_tpu_torch.parallel.sequences import MultiSequenceOdometry
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))
PORT_FILES = sorted((ROOT / "vslam_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES


def _load_example(path):
    """An example script as a module (the examples are not a package)."""
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_port_imports_without_jax():
    """Every port module, chip_smoke and every port example import with jax
    and vslam_tpu made unimportable, as on a machine that has no JAX."""
    code = (
        "import sys, pkgutil, importlib, importlib.util, pathlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['vslam_tpu'] = None\n"
        "import vslam_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(vslam_tpu_torch.__path__, 'vslam_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "examples = sorted(pathlib.Path('examples').glob('*_torch.py'))\n"
        "for p in examples:\n"
        "    spec = importlib.util.spec_from_file_location(p.stem, p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'vslam_tpu.')) for k, v in sys.modules.items() if v is not None)\n"
        "print(len(examples), len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    # the slices' modules, KITTI's, the suite's, the aligners', the mapping
    # backend's, the viewer's, the checkpoint's, the EXR and fixture readers
    # and the multi-GPU layer's (parallel.mesh, parallel.multihost) among them
    assert int(out.stdout.split()[-1]) >= 71
    assert int(out.stdout.split()[-2]) == len(EXAMPLES) == 5


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_name_no_jax_import(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "vslam_tpu"), (path, n)


def _tiny_problem(device="cpu"):
    B, F, P, H, W = 2, 1, 40, 12, 16
    g = torch.Generator().manual_seed(0)
    pcl = torch.rand(B, F, P, 3, generator=g) + torch.tensor([0.0, 0.0, 1.0])
    data = ICLevelData(pcl=pcl, J=torch.randn(B, F, P, 6, generator=g),
                       templ=torch.rand(B, F, P, generator=g) * 255,
                       mask=torch.ones(B, F, P, dtype=torch.bool),
                       n_constraints=torch.full((B, F), float(P)))
    rel0 = SE3(torch.eye(3).expand(B, F, 3, 3).contiguous(), torch.zeros(B, F, 3))
    cam = Camera(*(torch.full((B,), v) for v in (10.0, 10.0, 7.5, 5.5)))
    img = torch.rand(B, H, W, generator=g) * 255
    to = lambda x: x.to(device)  # noqa: E731
    return (ICLevelData(*map(to, data)), SE3(*map(to, rel0)), to(img), Camera(*map(to, cam)))


def test_kernel_launcher_raises_on_cpu_tensors():
    """The launcher never runs the plain version: CPU tensors are refused
    before any build or launch (solve_level_fused routes CPU tensors to the
    plain version one level up)."""
    data, rel0, img, cam = _tiny_problem()
    before = fused_solve.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        fused_solve._launch(data, rel0, img, cam, tic.AlignmentConfig(sampler="fused_gn"), None)
    assert fused_solve.LAUNCHES == before


def test_wrapper_takes_the_plain_version_only_for_cpu_tensors():
    """A tensor that is neither on the CPU nor on CUDA is refused, not solved
    by the plain version."""
    data, rel0, img, cam = _tiny_problem(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_solve.solve_level_fused(data, rel0, img, cam, tic.AlignmentConfig(sampler="fused_gn"), None)


def _launch_sample(device):
    data, rel, img, cam = _tiny_problem(device)
    return fused_ne._launch_sample, fused_ne.fused_level_sample, (data, rel, img, cam, "bilinear")


def _launch_ne(device):
    data, rel, img, cam = _tiny_problem(device)
    return fused_ne._launch_ne, fused_ne.fused_level_ne, (data, rel, img, cam, "nearest")


def _launch_mxu(device):
    _, _, img, _ = _tiny_problem(device)
    uv = torch.zeros(img.shape[0], 7, device=device)
    return pallas_kernels._launch, pallas_kernels.bilinear_sample_mxu, (img, uv, uv)


def _launches():
    return fused_ne.SAMPLE_LAUNCHES, fused_ne.NE_LAUNCHES, pallas_kernels.MXU_LAUNCHES


@pytest.mark.parametrize("kernel", [_launch_sample, _launch_ne, _launch_mxu],
                         ids=["fused_level_sample", "fused_level_ne", "bilinear_sample_mxu"])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_new_kernel_launchers_refuse_non_cuda_tensors(kernel, device):
    """The launcher of each per-iteration kernel refuses CPU tensors before
    any build or launch (the wrapper routes those to the plain version), and
    the wrapper refuses a tensor that is neither on the CPU nor on CUDA
    instead of running the plain version on it."""
    launch, wrapper, args = kernel(device)
    before = _launches()
    with pytest.raises(ValueError, match="CUDA"):
        (launch if device == "cpu" else wrapper)(*args)
    assert _launches() == before


def test_unknown_sampler_raises():
    data, rel0, img, cam = _tiny_problem()
    with pytest.raises(ValueError, match="sampler"):
        tic.solve_level(data, rel0, img, cam, tic.AlignmentConfig(sampler="onehot"), None)


# numpy stand-ins of the JAX package's state, read by field name as interop reads them
_NP_CAM = types.SimpleNamespace(fx=1.0, fy=1.0, cx=0.0, cy=0.0)
_NP_POSE = types.SimpleNamespace(R=np.eye(3), t=np.zeros(3))
_NP_LEVEL = types.SimpleNamespace(pcl=np.zeros((2, 3)), J=np.zeros((2, 6)), templ=np.zeros(2),
                                  mask=np.ones(2, bool), n_constraints=np.float32(2.0))
_NP_FRAME = types.SimpleNamespace(intensity=[np.zeros((4, 6))], depth=[np.ones((4, 6))], dIx=[np.zeros((4, 6))],
                                  dIy=[np.zeros((4, 6))], cameras=[_NP_CAM], pose=_NP_POSE)
_NP_EKF = types.SimpleNamespace(pose=_NP_POSE, velocity=np.zeros(6), P=np.eye(12), Q=np.eye(12))


def _kitti_depth():
    """A tensor on the device that `KittiDataset` block-matches on when none
    is named (its depth reaches the caller as numpy)."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        seq = pathlib.Path(d, "sequences", "00")
        for sub in ("image_0", "image_1"):
            (seq / sub).mkdir(parents=True)
            (seq / sub / "000000.png").write_bytes(b"")
        (seq / "times.txt").write_text("0.0\n")
        (seq / "calib.txt").write_text("P0: 1 0 0 0 0 1 0 0 0 0 1 0\nP1: 1 0 0 -0.5 0 1 0 0 0 0 1 0\n")
        ds = KittiDataset(d)
        return torch.zeros(1, device=ds.device)


def _group_of_one(device, make):
    """``make()`` inside a process group of one (over a file store) that
    `multihost.initialize` joined on ``device``; the group ends after."""
    import tempfile

    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as d:
        dev = multihost.initialize(f"file://{d}/store", 1, 0, device=device)
        try:
            return make(dev)
        finally:
            dist.destroy_process_group()


def _first_tensor_device(fn) -> torch.Tensor:
    """A tensor on the device of the first tensor ``fn()`` makes."""
    from torch.overrides import TorchFunctionMode

    seen = []

    class Record(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if torch.is_tensor(out) and not seen:
                seen.append(out.device)
            return out

    with Record():
        fn()
    return torch.zeros(1, device=seen[0])


def _render_boxes_batch_device() -> torch.Tensor:
    """A tensor on the device `render_boxes_batch` renders on when none is
    named (its images reach the caller as numpy)."""
    return _first_tensor_device(lambda: synthetic.render_boxes_batch(np.eye(3), [np.eye(4)], (2, 3)))


def _example_device() -> torch.Tensor:
    """A tensor on the device an example's ``main`` works on when given no
    ``--device`` (it prints only host numbers)."""
    example = _load_example(ROOT / "examples" / "robust_line_fit_torch.py")
    return _first_tensor_device(lambda: example.main([]))


def _cli_device() -> str:
    """The CLI's ``--device`` when none is given, the same on every command
    that tracks."""
    ap = evaluate.parser()
    devices = {ap.parse_args(argv).device for argv in (["synthetic"], ["odometry", "--dataset", "d"],
                                                       ["reproduce", "--dataset", "d"])}
    (device,) = devices
    return device


@pytest.mark.parametrize(
    "make",
    [
        lambda: Camera.create(1.0, 1.0, 0.0, 0.0).fx,
        lambda: se3.identity().R,
        lambda: ekf_se3.init().P,
        lambda: stage_stream(iter([(0, np.zeros((4, 6), np.uint8), np.zeros((4, 6), np.uint16))] * 2),
                             1)[1][0].intensity,
        lambda: interop.camera_from_numpy(_NP_CAM).fx,
        lambda: interop.se3_from_numpy(_NP_POSE).R,
        lambda: interop.frame_from_numpy(_NP_FRAME).intensity[0],
        lambda: interop.level_data_from_numpy(_NP_LEVEL).pcl,
        lambda: interop.level_data_tuple_from_numpy([_NP_LEVEL])[0].J,
        lambda: interop.ekf_state_from_numpy(_NP_EKF).P,
        lambda: OdometryPipeline(Camera(1.0, 1.0, 0.0, 0.0)).camera.fx,
        lambda: Camera.create(1.0, 1.0, 0.0, 0.0, device=_cli_device()).fx,
        lambda: _kitti_depth(),
        lambda: MultiSequenceOdometry([Camera(1.0, 1.0, 0.0, 0.0)] * 2).cameras.fx,
        lambda: torch.zeros(1, device=RgbdAlignerFa().device),
        lambda: torch.zeros(1, device=IcpAligner().device),
        lambda: torch.zeros(1, device=ChunkMappingBackend().device),
        _render_boxes_batch_device,
        lambda: _group_of_one("cpu", lambda _: torch.zeros(1, device=mesh_lib.mesh_device(batched.make_mesh()))),
        lambda: _group_of_one(None, lambda dev: torch.zeros(1, device=dev)),
        _example_device,
    ],
    ids=["Camera.create", "se3.identity", "ekf_se3.init", "stage_stream", "interop.camera_from_numpy",
         "interop.se3_from_numpy", "interop.frame_from_numpy", "interop.level_data_from_numpy",
         "interop.level_data_tuple_from_numpy", "interop.ekf_state_from_numpy", "OdometryPipeline",
         "evaluate --device", "KittiDataset", "MultiSequenceOdometry", "RgbdAlignerFa", "IcpAligner",
         "ChunkMappingBackend", "render_boxes_batch", "make_mesh", "multihost.initialize",
         "examples/robust_line_fit_torch.main"],
)
def test_entry_points_default_to_the_card(make):
    """With no device named, an entry point puts its tensors on CUDA, and
    without CUDA it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        assert make().is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            make()


@pytest.mark.parametrize("make", [
    lambda cam: SequentialOdometry(cam, SequentialConfig(), mapping=ChunkMappingBackend(device="cpu")),
    lambda cam: SequentialOdometry(cam, SequentialConfig(), mapping=ChunkMappingBackend(device="cpu"),
                                   async_mapping=False),
    lambda cam: MultiSequenceOdometry([cam, cam], SequentialConfig(),
                                      mappings=[ChunkMappingBackend(device="cpu") for _ in range(2)]),
    lambda cam: OdometryPipeline(cam, PipelineConfig(enable_mapping=True), device="cpu"),
    lambda cam: OdometryPipeline(cam, PipelineConfig(enable_loop_closure=True), device="cpu"),
], ids=["SequentialOdometry-mapping", "SequentialOdometry-sync-mapping", "MultiSequenceOdometry-mappings",
        "OdometryPipeline-enable_mapping", "OdometryPipeline-enable_loop_closure"])
def test_mapping_options_are_ported(make):
    """The mapping options no longer raise, and keep the backend they were given."""
    obj = make(Camera.create(100.0, 100.0, 31.5, 23.5, device="cpu"))
    if isinstance(obj, SequentialOdometry):
        assert obj.mapping is not None and obj.async_mapping == (obj._executor is not None)
    elif isinstance(obj, MultiSequenceOdometry):
        assert len(obj.mappings) == 2
    else:
        assert obj._tracking is not None


class _Viewers:
    """Records every `LiveViz` an entry point builds (the CLI and the
    pipeline import it from `vslam_tpu_torch.viz` when they need one)."""

    def __init__(self, monkeypatch):
        import vslam_tpu_torch.viz as viz_pkg

        self.made = []
        made = self.made

        class Recording(viz_pkg.LiveViz):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        monkeypatch.setattr(viz_pkg, "LiveViz", Recording)
        self.cls = Recording

    def close(self):
        for v in self.made:
            v.close()


def _mini_tum(root, seed):
    """A TUM directory of 4 PNG frames at 96x128 (`test_torch_evaluate`'s)."""
    from test_torch_evaluate import _build_mini_tum

    root.mkdir()
    return _build_mini_tum(root, 4, seed=seed)


def _viewer_sequential(cam, viewers, tmp_path, caplog):
    odo = SequentialOdometry(cam, SequentialConfig(), viz=viewers.cls(port=0))
    return odo.viz is viewers.made[0] and viewers.made[0].port > 0


def _viewer_pipeline(cam, viewers, tmp_path, caplog):
    pipe = OdometryPipeline(cam, PipelineConfig(live_viz_port=0), device="cpu")
    return pipe.viz is viewers.made[0] and viewers.made[0].port > 0


def _viewer_cli_odometry(cam, viewers, tmp_path, caplog):
    from test_torch_evaluate import INTRINSICS

    root = _mini_tum(tmp_path / "tum", seed=3)
    rc = evaluate.main(["odometry", "--dataset", str(root), "--out", str(tmp_path / "t.txt"), "--intrinsics",
                        INTRINSICS, "--live-viz", "0", "--device", "cpu", "--no-eval"])
    return rc == 0 and [v.state()["n_frames"] for v in viewers.made] == [4]


def _viewer_cli_synthetic(cam, viewers, tmp_path, caplog):
    rc = evaluate.main(["synthetic", "--frames", "5", "--fused", "--live-viz", "0", "--device", "cpu"])
    return rc == 0 and [v.state()["n_frames"] for v in viewers.made] == [5]


def _viewer_cli_suite(cam, viewers, tmp_path, caplog):
    import logging

    from test_torch_evaluate import INTRINSICS

    roots = [_mini_tum(tmp_path / name, seed=i) for i, name in enumerate(("a", "b"))]
    with caplog.at_level(logging.WARNING, logger="vslam_tpu_torch.system"):
        rc = evaluate.main(["odometry", "--dataset", str(roots[0]), "--dataset", str(roots[1]), "--out",
                            str(tmp_path / "s.txt"), "--intrinsics", INTRINSICS, "--fused", "--parity",
                            "--chunk", "4", "--live-viz", "0", "--device", "cpu", "--no-eval"])
    warned = any("--live-viz is not supported with multiple --dataset values" in r.getMessage()
                 for r in caplog.records)
    return rc == 0 and warned and not viewers.made


@pytest.mark.parametrize("check", [_viewer_sequential, _viewer_pipeline, _viewer_cli_odometry, _viewer_cli_synthetic,
                                   _viewer_cli_suite],
                         ids=["SequentialOdometry-viz", "OdometryPipeline-live_viz_port", "cli-odometry-host-loop",
                              "cli-synthetic-fused", "cli-suite-warns"])
def test_viewer_options_are_ported(check, monkeypatch, tmp_path, caplog):
    """The viewer options no longer raise: the entry points build or take a
    viewer and feed it every frame; suite mode warns and ignores the flag,
    as the JAX CLI does."""
    viewers = _Viewers(monkeypatch)
    try:
        assert check(Camera.create(100.0, 100.0, 31.5, 23.5, device="cpu"), viewers, tmp_path, caplog)
    finally:
        viewers.close()


def test_mapping_options_checked():
    """Unknown backend options and a backend count that is not one per
    sequence are refused."""
    for kw in ({"pose_write_back": "sometimes"}, {"ba_schedule": "x"}, {"track_schedule": "x"},
               {"compute_device": "tpu"}):
        with pytest.raises(ValueError):
            ChunkMappingBackend(device="cpu", **kw)
    with pytest.raises(ValueError, match="one mapping backend per sequence"):
        MultiSequenceOdometry([Camera.create(1.0, 1.0, 0.0, 0.0, device="cpu")] * 2,
                              mappings=[ChunkMappingBackend(device="cpu")])
    assert ChunkMappingBackend(device="cpu", compute_device="auto").compute_device == torch.device("cpu")


# what the port leaves out by decision (ROADMAP "Not ported"), as names
# relative to the package root
NOT_PORTED = {
    "utils.platform",  # interpret mode off the TPU; the wrappers pick by device
    "utils.profiling.cost_analysis",  # XLA's static cost model
    "utils.profiling.tpu_peaks",
    "utils.profiling.banded_segments_from_data",  # the Pallas kernel's bands
    "utils.profiling.fused_align_flops",  # the one-hot formulation's FLOPs
    "alignment.fused_ne.pack_level",  # the 8xC tile layout
    "alignment.fused_ne.FusedLevelPack",
    "alignment.fused_ne._BAND",
    "ba.pose_graph.optimize_pose_graph_jit",  # a jax.jit wrapper
}
JAX_MODULES = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
                     for p in (ROOT / "vslam_tpu").rglob("*.py"))


def _relative(module: str, name: str = "") -> str:
    return ".".join(x for x in (module.partition(".")[2], name) if x)


def _public(module) -> set:
    """``__all__``, or where a module has none, the functions and classes
    it defines under public names."""
    if hasattr(module, "__all__"):
        return set(module.__all__)
    return {k for k, v in vars(module).items() if not k.startswith("_") and (inspect.isfunction(v) or
            inspect.isclass(v)) and v.__module__ == module.__name__}


@pytest.mark.parametrize("name", JAX_MODULES)
def test_port_surface_covers_the_jax_package(name):
    """Every module and subpackage of the JAX package (the root included)
    has its port, whose public names (``__all__`` where the JAX module has
    one) hold the JAX module's, minus what is not ported by decision; every
    name the port's ``__all__`` lists resolves."""
    if _relative(name) in NOT_PORTED:
        return
    jax_module = importlib.import_module(name)
    port = importlib.import_module("vslam_tpu_torch" + name[len("vslam_tpu"):])
    want = {n for n in _public(jax_module) if _relative(name, n) not in NOT_PORTED}
    have = set(port.__all__) if hasattr(jax_module, "__all__") else {n for n in want if hasattr(port, n)}
    assert want <= have, sorted(want - have)
    assert all(hasattr(port, n) for n in getattr(port, "__all__", ())), name


def test_not_ported_names_exist_only_in_the_jax_package():
    """Each entry of NOT_PORTED names something of the JAX package that the
    port lacks, so the list cannot hide a name that was ported since."""

    def resolves(package: str, relative: str) -> bool:
        parts = relative.split(".")
        for i in range(len(parts), 0, -1):
            try:
                obj = importlib.import_module(".".join([package, *parts[:i]]))
            except ImportError:
                continue
            for attr in parts[i:]:
                if not hasattr(obj, attr):
                    return False
                obj = getattr(obj, attr)
            return True
        return False

    for relative in sorted(NOT_PORTED):
        assert resolves("vslam_tpu", relative), relative
        assert not resolves("vslam_tpu_torch", relative), relative


def test_console_scripts_name_both_clis():
    """``vslam-run-torch`` runs the port's CLI; ``vslam-run`` still names the
    JAX package's."""
    import tomllib

    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]["scripts"]
    assert scripts["vslam-run"] == "vslam_tpu.eval.evaluate:main"
    module, _, attr = scripts["vslam-run-torch"].partition(":")
    assert getattr(importlib.import_module(module), attr) is evaluate.main
    assert module == "vslam_tpu_torch.eval.evaluate"


def test_chip_smoke_result_line_keeps_the_contract():
    """The last line names one device (the run uses cuda:0), whatever
    torch.cuda.device_count() says, and carries exactly the contract's keys."""
    import json

    import chip_smoke

    line = json.loads(json.dumps(chip_smoke.result_line("NVIDIA H100 80GB HBM3")))
    assert line == {"ok": True, "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                                           "count": 1}}


@pytest.mark.parametrize("source,name,mirror", [("fused_solve.cu", "kCtas", "CTAS"),
                                                ("fused_solve.cu", "kShareAlign", "_SHARE_ALIGN"),
                                                ("warp_sample.cuh", "kThreads", "_THREADS"),
                                                ("fused_ne.cu", "kNeCtas", "NE_CTAS"),
                                                ("fused_ne.cu", "kNeClusterPoints", "NE_CLUSTER_POINTS"),
                                                ("fused_ne.cu", "kShareAlign", "_SHARE_ALIGN")])
def test_plain_version_mirrors_the_kernel_constants(source, name, mirror):
    """The plain whole-level solve and NE sum in their kernels' order only
    while their constants are the CUDA sources'. A mirror lives on the
    wrapper's module (fused_ne for the NE kernel's cluster) or, shared by
    both, on fused_solve."""
    import re

    text = (_build.SRC_DIR / source).read_text()
    (value,) = re.findall(rf"constexpr int {name} = (\d+);", text)
    owner = fused_ne if hasattr(fused_ne, mirror) else fused_solve
    assert int(value) == getattr(owner, mirror)


def test_build_names_the_hopper_target_and_refuses_without_nvcc(monkeypatch):
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert {p.name for p in _build.SRC_DIR.iterdir()} >= {
        "fused_solve.cu", "fused_ne.cu", "sample_mxu.cu", "warp_sample.cuh"}
    assert _build.BUILD_DIR.relative_to(ROOT).parts[0] == "build"  # inside .gitignore's build/
    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_alignment_config_from_jax_fields():
    cfg = JAlignmentConfig(
        min_gradient=12.5, solver=JSolverConfig(max_iterations=7, min_step_size=1e-9,
                                                min_relative_reduction=1e-3),
        loss=JLossConfig("Tukey", huber_c=2.0, tdistribution_v=3.0, scaler="mad"),
        include_prior=False, prior_weight=0.3,
        interpolation="nearest", orthonormalize=False, max_points=1234,
        sampler="fused_gn", image_dtype="bfloat16", normalize_intensity=True,
    )
    port = interop.alignment_config_from_fields(dataclasses.asdict(cfg))
    assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
    assert port.solver._min_gradient == cfg.solver._min_gradient
    assert dataclasses.asdict(tic.AlignmentConfig()) == dataclasses.asdict(JAlignmentConfig())


def test_sequential_config_from_jax_fields():
    from vslam_tpu.odometry.sequential import SequentialConfig as JSequentialConfig

    cfg = JSequentialConfig(
        alignment=JAlignmentConfig(loss=JLossConfig("Huber", scaler="mean"), sampler="fused_gn"),
        depth_scale=1.0 / 5000.0, prediction_model="Kalman", ekf_process_noise=3e-3,
        kf_period=7, kf_max_translation=0.1, include_key_frame=False, n_levels=4,
    )
    port = interop.sequential_config_from_fields(dataclasses.asdict(cfg))
    assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
    assert dataclasses.asdict(SequentialConfig()) == dataclasses.asdict(JSequentialConfig())
