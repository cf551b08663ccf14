"""The port's whole-level GN kernel against an earlier version's, on one
NVIDIA GPU, on the same tensors:

    python3 scripts/kernel_study.py --parent DIR

DIR holds the earlier version's tree (for example `git archive <commit> |
tar -x -C DIR`). Its `vslam_tpu_torch/csrc/fused_solve.cu` is built with
this package's nvcc flags and called through its own C entries; its robust
entry's residual and visibility scratch in global memory is allocated per
call. The inputs are those this version's main paths give the kernel, as
`chip_smoke.py` captures them: every level of `align_pairs` on the 64
rendered pairs (B = 64, F = 1) and of the odometry and the robust profile
(B = 1, F = 2; the solves of the last frame of the first chunk). Per path,
both kernels run in turns (this version, the earlier, the earlier, this
version; 20 launches each) in one profiler window, and each level's best of
two is printed with the iterations each evaluated, beside the card's name
and power limit. Then `chip_smoke.py`'s per-iteration split (phase 13) of
both versions at the level-0 inputs of both entries (`align_pairs`, the
robust profile). Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib.util
import pathlib
import subprocess
import sys
import types

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _parent_library(parent: pathlib.Path):
    """The earlier tree's whole-level kernel behind this package's C
    interface (`fused_solve._launch(lib=)`)."""
    import torch

    from vslam_tpu_torch import _build

    csrc = parent / "vslam_tpu_torch" / "csrc"
    lib_path = _build.BUILD_DIR / "variants" / "libvslam_fused_solve_parent.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib_path),
                    str(csrc / "fused_solve.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    quad, robust = lib.vslam_solve_level_fused, lib.vslam_solve_level_fused_robust
    quad.argtypes = _build._SIGNATURES["vslam_solve_level_fused"]
    robust.argtypes = _build._COMMON + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float] + [ctypes.c_void_p] * 6
    for fn in (quad, robust):
        fn.restype = ctypes.c_int
    scratch = []

    def robust_entry(*a):  # (…, tdist_v, out, chi2_hist, step_hist, stream)
        B, F, P = (a[i].value for i in (11, 12, 13))
        scratch[:] = [torch.empty(B, F, P, device="cuda") for _ in range(2)]
        return robust(*a[:-4], *(ctypes.c_void_p(t.data_ptr()) for t in scratch), *a[-4:])

    def smem(F, P, robust_, need, limit):  # its residual cache lives in global memory
        need._obj.value, limit._obj.value = 0, 1
        return 0

    return types.SimpleNamespace(vslam_solve_level_fused=quad, vslam_solve_level_fused_robust=robust_entry,
                                 vslam_solve_level_smem=smem)


@contextlib.contextmanager
def _launching(lib):
    """While the block runs, `fused_solve.solve_level_fused` launches the
    kernel of ``lib``."""
    from vslam_tpu_torch.alignment import fused_solve

    own = fused_solve.solve_level_fused
    fused_solve.solve_level_fused = lambda *a: fused_solve._from_out(a[1], *fused_solve._launch(*a, lib=lib))
    try:
        yield
    finally:
        fused_solve.solve_level_fused = own


def _inputs(cs, device):
    """{path: the whole-level kernel's per-level arguments, finest first}."""
    import torch

    from vslam_tpu_torch.core.camera import Camera
    from vslam_tpu_torch.core.se3 import SE3
    from vslam_tpu_torch.odometry.sequential import SequentialOdometry, stage_stream

    frames, _ = cs._render_pairs(device)
    rel0 = SE3(torch.eye(3, device=device).expand(cs.B, 3, 3).contiguous(), torch.zeros(cs.B, 3, device=device))
    x_pred = torch.zeros(cs.B, 6, device=device)
    levels = cs._level_inputs(frames, cs._production_cfg(), rel0, x_pred)
    out = {"align_pairs": [levels[level][1] for level in sorted(levels)]}
    camera = Camera.create(cs.FX, cs.FX, (cs.W - 1) / 2, (cs.H - 1) / 2, device=device)
    for name, (chunk, _, _) in cs.PROFILES.items():
        _, stream = cs._odometry_streams((name,), n=chunk + 1)[name]
        odo = SequentialOdometry(camera, cs._odometry_cfg(name), chunk=chunk)
        first, chunks = stage_stream(iter(stream), chunk, device=device)
        out[f"{name} profile"] = cs._profile_solve_inputs(odo, first, chunks)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="the earlier version's tree")
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_study: needs a CUDA device", file=sys.stderr)
        return 2
    from vslam_tpu_torch.alignment import fused_solve

    cs = _chip_smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    old = _parent_library(pathlib.Path(opts.parent).resolve())
    inputs = _inputs(cs, torch.device("cuda", 0))
    for label, per_level in inputs.items():
        groups, its = [], []
        for args in per_level:
            runs = {"new": (lambda a: lambda: fused_solve._from_out(a[1], *fused_solve._launch(*a)))(args),
                    "old": (lambda a: lambda: fused_solve._from_out(a[1], *fused_solve._launch(*a, lib=old)))(args)}
            its.append({k: int(cs._evaluated(fn()[1].chi2_history)) for k, fn in runs.items()})
            groups += [(runs[k], 20, "solve_level_kernel") for k in ("new", "old", "old", "new")]
        ms = cs._device_ms_batch(groups)
        sums = {"new": 0.0, "old": 0.0}
        for level, it in enumerate(its):
            m = ms[4 * level:4 * level + 4]
            best = {"new": min(m[0], m[3]), "old": min(m[1], m[2])}
            for k in sums:
                sums[k] += best[k]
            print(f"{label} level {level}: this version {best['new']:.4f} ms ({it['new']} it, runs {m[0]:.4f}, "
                  f"{m[3]:.4f}), the earlier {best['old']:.4f} ms ({it['old']} it, runs {m[1]:.4f}, {m[2]:.4f}) "
                  f"{card}", flush=True)
        print(f"{label}: this version {sums['new']:.4f} ms, the earlier {sums['old']:.4f} ms over 3 levels, "
              f"the same inputs, best of 2 each {card}", flush=True)
    log = lambda line: print(line, flush=True)  # noqa: E731
    for label in ("align_pairs", "robust profile"):
        cs._solve_split(inputs[label][0], f"{label}, this version", card, log)
        with _launching(old):
            cs._solve_split(inputs[label][0], f"{label}, the earlier version", card, log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
