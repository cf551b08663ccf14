"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` source is compiled at first use by its own nvcc, all of
them started together, into a shared library with a plain C interface,
loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/vslam_tpu_torch/libvslam_<source>_<hash>.so csrc/<source>.cu

The libraries land in `build/vslam_tpu_torch/` at the repository root,
named by a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is loaded as is. No source includes PyTorch's headers:
the build takes seconds, not minutes.

`Variants` builds a source with some of its design constants (a
`constexpr int` such as fused_solve.cu's kCtas) set to other values, so a
measurement can hold the alternatives against each other on the card; the
package itself only ever loads the sources as they are.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import types
from pathlib import Path

__all__ = ["build", "library", "Variants", "NVCC_FLAGS"]

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
# scaler_kind, huber_c, tdist_v, cache_r, cache_vis before out
_COMMON = [_VP] * 10 + [_I] * 8 + [_F, _I] + [_F] * 4 + [_I, _I]
_SIGNATURES = {
    "vslam_solve_level_fused": _COMMON + [_VP] * 4,
    "vslam_solve_level_fused_robust": _COMMON + [_I, _I, _F, _F] + [_VP] * 6,
    # (F, P, robust, need, limit)
    "vslam_solve_level_smem": [_I] * 3 + [_VP] * 2,
    # (F, P, points, need)
    "vslam_solve_level_global_cache": [_I] * 2 + [_VP] * 2,
    # (B, F, P, robust, image_is_bf16, bilinear, clusters)
    "vslam_solve_level_clusters": [_I] * 6 + [_VP],
    # (pcl, mask, rel_R, rel_t, cam, image, image_is_bf16, B, F, P, H, W,
    # bilinear, iwxp, visible, stream)
    "vslam_fused_level_sample": [_VP] * 6 + [_I] * 7 + [_VP] * 3,
    # (pcl, J, templ, mask, rel_R, rel_t, cam, image, image_is_bf16, B, F,
    # P, H, W, bilinear, out, stream)
    "vslam_fused_level_ne": [_VP] * 8 + [_I] * 7 + [_VP] * 2,
    # (img, u, v, B, M, H, W, out, stream)
    "vslam_bilinear_sample_mxu": [_VP] * 3 + [_I] * 4 + [_VP] * 2,
    # (img, dep, img_u8, dep_u16, scale, B, H, W, n_levels, out, stream)
    "vslam_frame_build": [_VP] * 2 + [_I] * 2 + [_F] + [_I] * 4 + [_VP] * 2,
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
    """Compile the kernels if needed, one nvcc per source, all started
    together. Returns (library paths, compiler log); ``verbose`` adds
    -Xptxas -v (registers, shared memory, spills) and always recompiles so
    the log is fresh."""
    units, all_files = _sources()
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in all_files:
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    libs = [BUILD_DIR / f"libvslam_{u.stem}_{digest.hexdigest()[:16]}.so" for u in units]
    todo = [(u, lib) for u, lib in zip(units, libs) if verbose or not lib.exists()]
    if not todo:
        return libs, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for unit, lib in todo:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *flags, "-I", str(SRC_DIR), "-o", str(tmp), str(unit)]
        jobs.append((lib, tmp, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for lib, tmp, cmd, proc in jobs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs, "".join(log)


def _entries(paths) -> types.SimpleNamespace:
    """The C entries found in the libraries at ``paths``, argtypes declared,
    as attributes named like the entries."""
    libs = [ctypes.CDLL(str(p)) for p in paths]
    entries = {}
    for name, argtypes in _SIGNATURES.items():
        for lib in libs:
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                entries[name] = fn
                break
    return types.SimpleNamespace(**entries)


@functools.lru_cache(maxsize=1)
def library() -> types.SimpleNamespace:
    """The C entries of the kernel libraries (built on first call), argtypes
    declared, as attributes named like the entries."""
    paths, _ = build()
    entries = _entries(paths)
    missing = set(_SIGNATURES) - set(vars(entries))
    if missing:
        raise RuntimeError(f"kernel libraries lack {sorted(missing)}")
    return entries


class Variants:
    """Libraries of single sources with design constants replaced: each
    spec is (source, {constexpr name: value}), the source a stem of
    `csrc/` or the path of another tree's `.cu` file (its own directory
    searched for includes). The nvcc processes start at construction, all
    together; `load()` waits for them and returns one entry namespace per
    spec."""

    def __init__(self, specs):
        nvcc = _nvcc()
        out_dir = BUILD_DIR / "variants"
        out_dir.mkdir(parents=True, exist_ok=True)
        self._jobs = []
        for i, (source, constants) in enumerate(specs):
            path = Path(source) if isinstance(source, Path) else SRC_DIR / f"{source}.cu"
            text = path.read_text()
            for name, value in constants.items():
                text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {int(value)};", text)
                if n != 1:
                    raise ValueError(f"{path.name} has no single 'constexpr int {name} = ...;'")
            tag = "_".join([path.stem, str(i)] + [f"{k}{v}" for k, v in constants.items()])
            src = out_dir / f"{tag}_{os.getpid()}.cu"
            src.write_text(text)
            lib = out_dir / f"libvslam_{tag}_{os.getpid()}.so"
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(path.parent), "-o", str(lib), str(src)]
            self._jobs.append((lib, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                          stderr=subprocess.STDOUT, text=True)))

    def load(self):
        failed, paths = [], []
        for lib, cmd, proc in self._jobs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
            paths.append(lib)
        if failed:
            raise RuntimeError("\n".join(failed))
        return [_entries([p]) for p in paths]
