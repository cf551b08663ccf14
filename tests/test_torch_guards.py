"""Guards of the port's boundaries: it imports without JAX, its kernel
wrapper never falls back silently, and what it does not port yet raises."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from vslam_tpu.alignment.ic import AlignmentConfig as JAlignmentConfig
from vslam_tpu.solvers import LossConfig as JLossConfig
from vslam_tpu.solvers import SolverConfig as JSolverConfig
from vslam_tpu_torch import _build, interop
from vslam_tpu_torch.alignment import fused_solve
from vslam_tpu_torch.alignment import ic as tic
from vslam_tpu_torch.alignment.ic import ICLevelData
from vslam_tpu_torch.core.camera import Camera
from vslam_tpu_torch.core.se3 import SE3
from vslam_tpu_torch.solvers import LossConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "vslam_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_without_jax():
    """Every port module (and chip_smoke) imports with jax and vslam_tpu
    made unimportable, as on a machine that has no JAX."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['vslam_tpu'] = None\n"
        "import vslam_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(vslam_tpu_torch.__path__, 'vslam_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'vslam_tpu.')) for k, v in sys.modules.items() if v is not None)\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15  # the slice's modules


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


@pytest.mark.parametrize(
    "cfg,what",
    [
        (tic.AlignmentConfig(loss=LossConfig("Huber")), "loss"),
        (tic.AlignmentConfig(sampler="fused_gn", loss=LossConfig("Tukey")), "loss"),
        (tic.AlignmentConfig(sampler="mxu"), "sampler"),
        (tic.AlignmentConfig(sampler="fused"), "sampler"),
        (tic.AlignmentConfig(normalize_intensity=True), "normalize_intensity"),
    ],
)
def test_unported_options_raise(cfg, what):
    data, rel0, img, cam = _tiny_problem()
    with pytest.raises(NotImplementedError, match=what):
        tic.solve_level(data, rel0, img, cam, cfg, None)


def test_build_names_the_hopper_target_and_refuses_without_nvcc(monkeypatch):
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert {p.name for p in _build.SRC_DIR.iterdir()} >= {"fused_solve.cu", "warp_sample.cuh"}
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
        loss=JLossConfig("None", huber_c=2.0), include_prior=False, prior_weight=0.3,
        interpolation="nearest", orthonormalize=False, max_points=1234,
        sampler="fused_gn", image_dtype="bfloat16",
    )
    port = interop.alignment_config_from_fields(dataclasses.asdict(cfg))
    assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
    assert port.solver._min_gradient == cfg.solver._min_gradient
    assert dataclasses.asdict(tic.AlignmentConfig()) == dataclasses.asdict(JAlignmentConfig())
