"""Build and load the port's CUDA kernels.

The sources in `csrc/` are compiled at first use by nvcc into one shared
library with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/vslam_tpu_torch/libvslam_kernels_<hash>.so csrc/*.cu

The library lands in `build/vslam_tpu_torch/` at the repository root,
named by a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is loaded as is. No source includes PyTorch's headers:
the build takes seconds, not minutes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["build", "library", "NVCC_FLAGS"]

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "vslam_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # no multiply-add contraction: the plain PyTorch version rounds every
    # product and sum separately, and the two are held to the same bits
    "-fmad=false",
]

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# vslam_solve_level_fused(10 pointers, image_is_bf16, B, F, P, H, W, bilinear,
# include_prior, prior_weight, max_iterations, min_step_size, min_gradient,
# min_reduction, min_relative_reduction, use_min_rel, orthonormalize, out,
# chi2_hist, step_hist, stream); the robust entry adds loss_kind,
# scaler_kind, huber_c, tdist_v, r_buf, vis_buf before out
_COMMON = [_VP] * 10 + [_I] * 8 + [_F, _I] + [_F] * 4 + [_I, _I]
_SIGNATURES = {
    "vslam_solve_level_fused": _COMMON + [_VP] * 4,
    "vslam_solve_level_fused_robust": _COMMON + [_I, _I, _F, _F] + [_VP] * 6,
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(SRC_DIR.glob("*.cu")), sorted(SRC_DIR.glob("*.cu*"))


def build(verbose: bool = False):
    """Compile the kernels if needed. Returns (library path, compiler log);
    ``verbose`` adds -Xptxas -v (registers, shared memory, spills) and always
    recompiles so the log is fresh."""
    units, all_files = _sources()
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in all_files:
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    lib = BUILD_DIR / f"libvslam_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists() and not verbose:
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags, "-I", str(SRC_DIR), "-o", str(tmp), *map(str, units)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), argtypes declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
