"""The port's kernels against an earlier version's, on one NVIDIA GPU, on
the same tensors:

    python3 scripts/kernel_study.py --parent DIR [--mxu-only]

DIR holds the earlier version's tree (for example `git archive <commit> |
tar -x -C DIR`), whose C entries have this version's signatures: its
`vslam_tpu_torch/csrc/fused_solve.cu`, `fused_ne.cu` and `sample_mxu.cu`
are built with this package's nvcc flags and called through them. The inputs
are those this version's main paths give the kernels, as `chip_smoke.py`
captures them:

- the whole-level kernel: every level of `align_pairs` on the 64 rendered
  pairs (B = 64, F = 1) and of the odometry and the robust profile (B = 1,
  F = 2; the solves of the last frame of the first chunk);
- the NE kernel (`fused_level_ne`): every level of `align_pairs` with the
  `fused` sampler (phase 10);
- the sample kernel (`fused_level_sample`): every level of `tracking_step`
  with the `fused` sampler and the Huber loss (phase 10), and of the visual
  log's F = 2 `RgbdAligner.align` (phase 11);
- the mxu kernel (`bilinear_sample_mxu`): every level of `align_pairs`
  with the `mxu` sampler (phase 10).

Per path, both versions run in turns (this version, the earlier, the
earlier, this version; 20 launches each) in one profiler window, and each
level's best of two is printed (with the iterations each evaluated, for the
whole-level kernel) beside the card's name and power limit. Then
`chip_smoke.py`'s per-iteration split (phase 13) of both whole-level
versions at the level-0 inputs of both entries (`align_pairs`, the robust
profile), and its split of the mxu kernel (phase 15: an empty kernel on the
grid, the coordinates alone, the full kernel) for both versions, the
earlier one's flat grid from `scripts/sample_mxu_flat_split.cu`, this
version's beside MXU_PROBES. Then the mxu kernel's design variants, all
builds of `scripts/sample_mxu_variants.cu` (the package's kernel with the
variants measured and not taken): each build of `_mxu_variants` (one
constant of MXU_TRIED moved from that source's value) held bit for bit
against the plain version, then timed beside the package's build, the
earlier version's and that source's own in turns (the builds in order, then
reversed; best of two). Last, the mxu kernel inside `align_pairs`' mxu run,
where other kernels run between its launches (`_mxu_in_path`): the
package's build and the earlier version, MXU_PATH_ROUNDS rounds in turns,
with each one's median and quartiles and the package's wins. ``--mxu-only`` runs the mxu kernel's part
alone (~5 min with the builds). Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import pathlib
import re
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


# the mxu kernel's design variants: the study's source (the package's kernel
# at its values), its design constants and the values tried, each moved
# alone from the source's value
MXU_VARIANTS = REPO / "scripts" / "sample_mxu_variants.cu"
MXU_TRIED = {"kMxuPts": (1, 2, 4), "kMxuMaxThreads": (128, 256, 512), "kMxuMinBlocks": (0, 132, 264, 528),
             "kMxuPairedPoints": (0, 65536, 2**31 - 1), "kMxuEvictLast": (0, 25, 50, 100),
             "kMxuStreaming": (0, 1)}


def _variants_constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", MXU_VARIANTS.read_text())[1])


def _mxu_variants():
    """The builds of the study's source that it times: one constant of
    MXU_TRIED moved from the source's value."""
    own = {k: _variants_constant(k) for k in MXU_TRIED}
    return [{k: x} for k, values in MXU_TRIED.items() for x in values if x != own[k]]


# beside this version's split, the study source's measurement builds of the
# full kernel (kMxuStage): every pair's taps read from the first pair's image (the taps'
# L2 footprint cut B-fold), and the upper row's taps alone (half the lines)
MXU_PROBES = {"taps of image 0 alone": 3, "upper row alone": 4}


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


def _inputs(cs, device, mxu_only):
    """({path: the whole-level kernel's per-level arguments, finest first},
    {(per-iteration kernel, path): its per-level arguments, finest first},
    (the rendered pairs, the `align_pairs` mxu configuration)); with
    ``mxu_only``, only the mxu kernel's."""
    import torch

    from vslam_tpu_torch.alignment import fused_ne
    from vslam_tpu_torch.core.camera import Camera
    from vslam_tpu_torch.core.se3 import SE3
    from vslam_tpu_torch.odometry.sequential import SequentialOdometry, stage_stream

    quiet = lambda line: None  # noqa: E731
    by_width = lambda d: [d[w] for w in sorted(d, reverse=True)]  # noqa: E731
    frames, xis = cs._render_pairs(device)
    _, captured, _, cfgs = cs._per_iteration_paths(frames, xis, cs._new_kernels(), quiet)
    per_iteration = {("bilinear_sample_mxu", "align_pairs, sampler mxu, bilinear, f32"):
                     by_width(captured["bilinear_sample_mxu"])}
    mxu_run = (frames, cfgs["mxu"])
    if mxu_only:
        return {}, per_iteration, mxu_run
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
    per_iteration["fused_level_ne", "align_pairs, sampler fused"] = by_width(captured["fused_level_ne"])
    per_iteration["fused_level_sample", "tracking_step, sampler fused, Huber"] = by_width(
        captured["fused_level_sample"])
    vlog = {}
    with cs._tap(fused_ne, "fused_level_sample", lambda a, _: vlog.__setitem__(a[2].shape[-1], a)):
        cs._visual_log(*streams["odometry"], camera, quiet)
    per_iteration["fused_level_sample", "visual log, RgbdAligner F=2"] = by_width(vlog)
    return out, per_iteration, mxu_run


def _shape(args) -> str:
    """The launch's sizes: B, F, P of a level's data, or B, M and the image
    of the mxu kernel's (img, u, v)."""
    if len(args) == 3:
        img, u, _ = args
        return f"B={u.shape[0]}, M={u.shape[1]}, {img.shape[-2]}x{img.shape[-1]}"
    B_, F_, P_ = args[0].mask.shape
    return f"B={B_}, F={F_}, P={P_}"


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
        print(f"{label} level {level} ({_shape(args)}): this version {best['new']:.3f} us ({d['new']}runs "
              f"{m[0]:.3f}, {m[3]:.3f}), the earlier {best['old']:.3f} us ({d['old']}runs {m[1]:.3f}, {m[2]:.3f}) "
              f"{card}", flush=True)
    print(f"{label}: this version {sums['new']:.3f} us, the earlier {sums['old']:.3f} us over {len(per_level)} "
          f"levels, the same inputs, best of 2 each {card}", flush=True)


def _mxu_sweep(cs, per_level, builds, card, log):
    """The mxu kernel's builds (``builds``, {name: C entries, None for the
    package's}) at each level's inputs: each held bit for bit against the
    plain version, then timed (device ms, profiler, 20 launches) in two runs
    in turns (the builds in order, then reversed) in one window; the best
    of the two, and the fastest build at each level."""
    from vslam_tpu_torch.alignment import pallas_kernels as pk

    names, runs = list(builds), {}
    for name, lib in builds.items():
        for li, args in enumerate(per_level):
            runs[name, li] = (lambda a, lib: lambda: pk._launch(*a, lib=lib))(args, lib)
            err = cs._max_abs_diff(runs[name, li](), pk.bilinear_sample_mxu_plain(*args))
            if err != 0.0:
                raise AssertionError(f"mxu sweep {name} level {li}: kernel and plain differ by {err}")
    order = [(name, li) for name in names + names[::-1] for li in range(len(per_level))]
    ms = cs._device_ms_batch([(runs[key], 20, "sample_mxu_kernel") for key in order])
    widths = " / ".join(f"{a[0].shape[-1]}-wide" for a in per_level)
    best = {}
    for name in names:
        pairs = [[m for key, m in zip(order, ms) if key == (name, li)] for li in range(len(per_level))]
        best[name] = [min(p) for p in pairs]
        log(f"mxu sweep {name}: " + " / ".join(
            f"{min(p) * 1e3:.3f} us (runs {p[0] * 1e3:.3f}, {p[1] * 1e3:.3f})" for p in pairs)
            + f" at the {widths} levels, {sum(best[name]) * 1e3:.3f} us over {len(per_level)}; bit-equal with "
            f"the plain version {card}")
    fastest = [min(names, key=lambda n: best[n][li]) for li in range(len(per_level))]
    log(f"mxu sweep: fastest per level (finest first) {fastest}; the source's "
        + ", ".join(f"{k} = {_variants_constant(k)}" for k in MXU_TRIED) + f" {card}")


MXU_PATH_ROUNDS = 5


def _mxu_in_path(cs, frames, cfg, builds, card, log):
    """The mxu kernel inside `align_pairs`' mxu run (phase 10's), other
    kernels between its launches: per build ({name: C entries}, None for
    the package's), the device us of its launches in one call at each
    level (a profiler window of device activity alone; the launches matched
    to their levels in order), MXU_PATH_ROUNDS rounds of the builds in
    turns (in order, then reversed), the mean, median and quartiles of
    each, and the first build's wins against each other build (its k-th run
    below theirs); each build's poses the package's, bit for bit."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vslam_tpu_torch.alignment import pallas_kernels as pk
    from vslam_tpu_torch.core.se3 import SE3
    from vslam_tpu_torch.parallel.batched import align_pairs

    dev = frames["cur"].intensity[0].device
    rel0 = SE3(torch.eye(3, device=dev).expand(cs.B, 3, 3).contiguous(), torch.zeros(cs.B, 3, device=dev))
    x_pred = torch.zeros(cs.B, 6, device=dev)
    own = pk.bilinear_sample_mxu

    def call(lib, widths):
        """align_pairs' poses, each launch's image width appended to widths"""
        pk.bilinear_sample_mxu = lambda img, u, v: widths.append(img.shape[-1]) or pk._launch(img, u, v, lib=lib)
        try:
            rel = align_pairs(frames["ref"], frames["cur"], rel0, x_pred, cfg)[0]
            cs._sync()
            return rel
        finally:
            pk.bilinear_sample_mxu = own

    want = call(None, [])
    names = list(builds)
    runs = {name: [] for name in names}
    for name in (names + names[::-1]) * MXU_PATH_ROUNDS:
        for _ in range(cs.PROFILER_ATTEMPTS):
            widths = []
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                got = call(builds[name], widths)
                time.sleep(0.01)
            on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            kernels = sorted((e for e in on_device if "sample_mxu_kernel" in e.name),
                             key=lambda e: e.time_range.start)
            if len(kernels) == len(widths):
                break
        else:
            raise AssertionError(f"mxu in the path {name}: the profiler saw {len(kernels)} of {len(widths)} launches")
        if not (torch.equal(got.R, want.R) and torch.equal(got.t, want.t)):
            raise AssertionError(f"mxu in the path {name}: poses differ from the package's build")
        per_level = {"all": [sum(e.time_range.end - e.time_range.start for e in on_device)]}
        for width, e in zip(widths, kernels):
            per_level.setdefault(width, []).append(e.time_range.end - e.time_range.start)
        runs[name].append(per_level)
    totals = {}
    for name in names:
        widths = sorted((w for w in runs[name][0] if w != "all"), reverse=True)
        totals[name] = total = [sum(sum(run[w]) for w in widths) for run in runs[name]]
        every = [run["all"][0] for run in runs[name]]
        q1, median, q3 = np.percentile(total, [25, 50, 75])
        log(f"mxu in the path {name}: {np.mean(total):.3f} us of device time a call of align_pairs, median "
            f"{median:.3f}, quartiles {q1:.3f} - {q3:.3f} (runs " + ", ".join(f"{t:.3f}" for t in total)
            + "); by level, launches and us per launch: " + " / ".join(
                f"{w}-wide {len(runs[name][0][w])} x {np.mean([np.mean(run[w]) for run in runs[name]]):.3f}"
                for w in widths) + f"; every kernel of the call {np.mean(every) / 1e3:.3f} ms (runs "
            + ", ".join(f"{t / 1e3:.3f}" for t in every) + f"); poses bit-equal with the package's build {card}")
    own = names[0]
    for name in names[1:]:
        wins = sum(a < b for a, b in zip(totals[own], totals[name]))
        log(f"mxu in the path: {own} below {name} in {wins} of {len(totals[own])} pairs (the k-th run of each, "
            f"the builds in turns) {card}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="the earlier version's tree")
    ap.add_argument("--mxu-only", action="store_true", help="the mxu kernel's part alone")
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_study: needs a CUDA device", file=sys.stderr)
        return 2
    from vslam_tpu_torch import _build
    from vslam_tpu_torch.alignment import fused_ne, fused_solve, pallas_kernels

    cs = _chip_smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    log = lambda line: print(line, flush=True)  # noqa: E731
    csrc = pathlib.Path(opts.parent).resolve() / "vslam_tpu_torch" / "csrc"
    flat = REPO / "scripts" / "sample_mxu_flat_split.cu"
    mxu_variants = _mxu_variants()
    # every build at once: the earlier version's sources, both designs' split
    # stages, the mxu kernel's design variants
    specs = {"old_mxu": (csrc / "sample_mxu.cu", {})}
    if not opts.mxu_only:
        specs.update(old=(csrc / "fused_solve.cu", {}), old_ne=(csrc / "fused_ne.cu", {}))
    specs.update({("flat", s): (flat, {"kMxuStage": s}) for s in (0, 1)})
    specs.update({("new", s): ("sample_mxu", {"kMxuStage": s}) for s in (0, 1)})
    specs.update({("probe", s): (MXU_VARIANTS, {"kMxuStage": s}) for s in MXU_PROBES.values()})
    specs["variants base"] = (MXU_VARIANTS, {})
    specs.update({("variant", i): (MXU_VARIANTS, v) for i, v in enumerate(mxu_variants)})
    builds = _build.Variants(list(specs.values()))
    inputs, per_iteration, mxu_run = _inputs(cs, torch.device("cuda", 0), opts.mxu_only)
    libs = dict(zip(specs, builds.load()))
    launches = {"fused_level_ne": (fused_ne._launch_ne, "level_ne_kernel"),
                "fused_level_sample": (fused_ne._launch_sample, "sample_level_kernel"),
                "bilinear_sample_mxu": (pallas_kernels._launch, "sample_mxu_kernel")}
    for (kernel, label), per_level in per_iteration.items():
        launch, cuda_name = launches[kernel]
        old = libs["old_mxu" if kernel == "bilinear_sample_mxu" else "old_ne"]
        _in_turns(cs, f"{kernel}, {label}", per_level, lambda a, lib: launch(*a, lib=lib), old, cuda_name, card)
    solve = lambda a, lib: fused_solve._from_out(a[1], *fused_solve._launch(*a, lib=lib))  # noqa: E731
    iterations = lambda run: f"{int(cs._evaluated(run()[1].chi2_history))} it, "  # noqa: E731
    for label, per_level in inputs.items():
        _in_turns(cs, label, per_level, solve, libs["old"], "solve_level_kernel", card, iterations)
    for label in ("align_pairs", "robust profile") if inputs else ():
        cs._solve_split(inputs[label][0], f"{label}, this version", card, log)
        with _launching(libs["old"]):
            cs._solve_split(inputs[label][0], f"{label}, the earlier version", card, log)
    mxu_levels = per_iteration["bilinear_sample_mxu", "align_pairs, sampler mxu, bilinear, f32"]
    by_width = {args[0].shape[-1]: args for args in mxu_levels}
    split = {name: libs.get(("new", s)) for s, name in cs.MXU_STAGES.items()}  # the full kernel: the package's
    split.update({name: libs["probe", s] for name, s in MXU_PROBES.items()})
    cs._mxu_split(by_width, split, "this version", card, log)
    split = {name: libs["flat", s] if ("flat", s) in libs else libs["old_mxu"] for s, name in cs.MXU_STAGES.items()}
    cs._mxu_split(by_width, split, "the earlier version", card, log)
    names = {"the package's build": None, "the earlier version": libs["old_mxu"],
             "the study source at the package's values": libs["variants base"]}
    names.update({" ".join(f"{k}={x}" for k, x in v.items()): libs["variant", i] for i, v in enumerate(mxu_variants)})
    _mxu_sweep(cs, mxu_levels, names, card, log)
    _mxu_in_path(cs, *mxu_run, {name: names[name] for name in ("the package's build", "the earlier version")},
                 card, log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
