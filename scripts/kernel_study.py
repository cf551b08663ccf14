"""The port's kernels against an earlier version's, on one NVIDIA GPU, on
the same tensors:

    python3 scripts/kernel_study.py --parent DIR

DIR holds the earlier version's tree (for example `git archive <commit> |
tar -x -C DIR`), whose C entries have this version's signatures: its
`vslam_tpu_torch/csrc/fused_solve.cu` and `fused_ne.cu` are built with this
package's nvcc flags and called through them. The inputs
are those this version's main paths give the kernels, as `chip_smoke.py`
captures them:

- the whole-level kernel: every level of `align_pairs` on the 64 rendered
  pairs (B = 64, F = 1) and of the odometry and the robust profile (B = 1,
  F = 2; the solves of the last frame of the first chunk);
- the NE kernel (`fused_level_ne`): every level of `align_pairs` with the
  `fused` sampler (phase 10);
- the sample kernel (`fused_level_sample`): every level of `tracking_step`
  with the `fused` sampler and the Huber loss (phase 10), and of the visual
  log's F = 2 `RgbdAligner.align` (phase 11).

Per path, both versions run in turns (this version, the earlier, the
earlier, this version; 20 launches each) in one profiler window, and each
level's best of two is printed (with the iterations each evaluated, for the
whole-level kernel) beside the card's name and power limit. Then
`chip_smoke.py`'s per-iteration split (phase 13) of both whole-level
versions at the level-0 inputs of both entries (`align_pairs`, the robust
profile). Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _parent_library(parent: pathlib.Path, stem: str):
    """The C entries of the earlier tree's ``stem``.cu, built with this
    package's flags (for `fused_solve._launch(lib=)`, `fused_ne._launch_ne(lib=)`
    and `_launch_sample(lib=)`)."""
    from vslam_tpu_torch import _build

    csrc = parent / "vslam_tpu_torch" / "csrc"
    lib_path = _build.BUILD_DIR / "variants" / f"libvslam_{stem}_parent.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib_path),
                    str(csrc / f"{stem}.cu")], check=True)
    return _build._entries([lib_path])


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
    """({path: the whole-level kernel's per-level arguments, finest first},
    {(per-iteration kernel, path): its per-level arguments, finest first})."""
    import torch

    from vslam_tpu_torch.alignment import fused_ne
    from vslam_tpu_torch.core.camera import Camera
    from vslam_tpu_torch.core.se3 import SE3
    from vslam_tpu_torch.odometry.sequential import SequentialOdometry, stage_stream

    frames, xis = cs._render_pairs(device)
    rel0 = SE3(torch.eye(3, device=device).expand(cs.B, 3, 3).contiguous(), torch.zeros(cs.B, 3, device=device))
    x_pred = torch.zeros(cs.B, 6, device=device)
    levels = cs._level_inputs(frames, cs._production_cfg(), rel0, x_pred)
    out = {"align_pairs": [levels[level][1] for level in sorted(levels)]}
    camera = Camera.create(cs.FX, cs.FX, (cs.W - 1) / 2, (cs.H - 1) / 2, device=device)
    streams = {}
    for name, (chunk, _, _) in cs.PROFILES.items():
        streams[name] = cs._odometry_streams((name,), n=chunk + 1)[name]
        odo = SequentialOdometry(camera, cs._odometry_cfg(name), chunk=chunk)
        first, chunks = stage_stream(iter(streams[name][1]), chunk, device=device)
        out[f"{name} profile"] = cs._profile_solve_inputs(odo, first, chunks)
    quiet = lambda line: None  # noqa: E731
    _, captured, _, _ = cs._per_iteration_paths(frames, xis, cs._new_kernels(), quiet)
    by_width = lambda d: [d[w] for w in sorted(d, reverse=True)]  # noqa: E731
    per_iteration = {("fused_level_ne", "align_pairs, sampler fused"): by_width(captured["fused_level_ne"]),
                     ("fused_level_sample", "tracking_step, sampler fused, Huber"):
                         by_width(captured["fused_level_sample"])}
    vlog = {}
    with cs._tap(fused_ne, "fused_level_sample", lambda a, _: vlog.__setitem__(a[2].shape[-1], a)):
        cs._visual_log(*streams["odometry"], camera, quiet)
    per_iteration["fused_level_sample", "visual log, RgbdAligner F=2"] = by_width(vlog)
    return out, per_iteration


def _in_turns(cs, label, per_level, launch, old, cuda_name, card, detail=lambda run: ""):
    """``launch(args, lib)`` at each level's ``args``, this version (lib
    None) and the earlier (``old``) in turns (this, the earlier, the
    earlier, this; 20 launches each) in one profiler window: each level's
    best of two and their sum, with ``detail(run)`` of each version's run."""
    groups, details = [], []
    for args in per_level:
        runs = {k: (lambda a, lib: lambda: launch(a, lib))(args, lib) for k, lib in (("new", None), ("old", old))}
        details.append({k: detail(run) for k, run in runs.items()})
        groups += [(runs[k], 20, cuda_name) for k in ("new", "old", "old", "new")]
    ms = cs._device_ms_batch(groups)
    sums = {"new": 0.0, "old": 0.0}
    for level, (args, d) in enumerate(zip(per_level, details)):
        m = [x * 1e3 for x in ms[4 * level:4 * level + 4]]
        best = {"new": min(m[0], m[3]), "old": min(m[1], m[2])}
        for k in sums:
            sums[k] += best[k]
        B_, F_, P_ = args[0].mask.shape
        print(f"{label} level {level} (B={B_}, F={F_}, P={P_}): this version {best['new']:.3f} us ({d['new']}runs "
              f"{m[0]:.3f}, {m[3]:.3f}), the earlier {best['old']:.3f} us ({d['old']}runs {m[1]:.3f}, {m[2]:.3f}) "
              f"{card}", flush=True)
    print(f"{label}: this version {sums['new']:.3f} us, the earlier {sums['old']:.3f} us over {len(per_level)} "
          f"levels, the same inputs, best of 2 each {card}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="the earlier version's tree")
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_study: needs a CUDA device", file=sys.stderr)
        return 2
    from vslam_tpu_torch.alignment import fused_ne, fused_solve

    cs = _chip_smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    parent = pathlib.Path(opts.parent).resolve()
    old = _parent_library(parent, "fused_solve")
    old_ne = _parent_library(parent, "fused_ne")
    inputs, per_iteration = _inputs(cs, torch.device("cuda", 0))
    launches = {"fused_level_ne": (fused_ne._launch_ne, "level_ne_kernel"),
                "fused_level_sample": (fused_ne._launch_sample, "sample_level_kernel")}
    for (kernel, label), per_level in per_iteration.items():
        launch, cuda_name = launches[kernel]
        _in_turns(cs, f"{kernel}, {label}", per_level, lambda a, lib: launch(*a, lib=lib), old_ne, cuda_name, card)
    solve = lambda a, lib: fused_solve._from_out(a[1], *fused_solve._launch(*a, lib=lib))  # noqa: E731
    iterations = lambda run: f"{int(cs._evaluated(run()[1].chi2_history))} it, "  # noqa: E731
    for label, per_level in inputs.items():
        _in_turns(cs, label, per_level, solve, old, "solve_level_kernel", card, iterations)
    log = lambda line: print(line, flush=True)  # noqa: E731
    for label in ("align_pairs", "robust profile"):
        cs._solve_split(inputs[label][0], f"{label}, this version", card, log)
        with _launching(old):
            cs._solve_split(inputs[label][0], f"{label}, the earlier version", card, log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
