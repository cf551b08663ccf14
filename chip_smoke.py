"""Drive the PyTorch / CUDA port (`vslam_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each ending in torch.cuda.synchronize():
  1. device   — requires CUDA (no CPU fallback); prints the card's name and
                power limit as nvidia-smi reports them
  2. build    — nvcc-builds the kernels from vslam_tpu_torch/csrc, and
                beside them the sweeps' variants (the whole-level kernel at
                each CTA count of CTAS_TRIED, and RESIDUAL_SWEEPS) and the
                mxu kernel's split stages (MXU_STAGES), one nvcc each, all
                started together
  3. kernel   — the whole-level GN kernel's quadratic entry against its plain
                PyTorch version on the same tensors: 64 rendered 480x640
                pairs, finest level, four cases (F=1 nearest bf16, F=1
                nearest f32, F=2 + prior nearest f32, F=1 bilinear f32)
  4. robust   — the kernel's robust entry against the plain version on the
                same pairs: the 7 loss x scaler cases (F=1 nearest f32) and
                Huber F=2 + prior nearest bf16
  5. main     — `align_pairs` on the 64 pairs with the production profile
                (3 levels, 2048 points, nearest, bf16, prior, GN <= 100):
                one kernel launch per level, and the per-pair SE(3) error
                gate (< 0.01)
  6. tracking — `tracking_step` on the 64 pairs, the same profile with the
                Huber loss, from zero-velocity filters: 3 robust launches,
                every pair valid, mean error < 0.01
  7. odometry — `SequentialOdometry` over 64 frames at 480x640 in two
                profiles: the odometry profile (smooth trajectory, quadratic,
                bilinear; ATE < 0.01 m) and the robust profile (box scene,
                first 64 frames of the 256-frame orbit, Huber, nearest;
                ATE < 0.02 m), each with 3 x 63 kernel launches
  8. times    — align_pairs pairs/s and per-level kernel and plain ms, both
                odometry profiles' frames/s (staged and streamed), and each
                profile's kernel per level against the plain version at the
                solve inputs the main path gave it (held to phase 3's
                limits, folded into max_abs_err) with its device ms beside
                the plain version's; last, under torch.profiler, the layers
                of a step (record_function ranges) and the device-busy share
  9. samplers — the per-iteration kernels against their plain versions on
                the 64 pairs' finest level at a non-identity pose: sample
                and NE in {nearest, bilinear} x {f32, bf16} at F=1 and F=2;
                the mxu sampler at the warped points and at 4096 points per
                pair on and outside the image border; bit for bit
 10. per-iteration path — align_pairs (production profile, sampler
                "fused"), tracking_step ("fused", Huber) and align_pairs
                ("mxu", bilinear, f32) on the 64 pairs: each new kernel
                launched once per evaluation of the batched GN loop, no
                whole-level launch, every pair valid, mean error < 0.01;
                then each kernel against its plain version at the inputs
                each level gave it, bit for bit
 11. visual log — RgbdAligner (F=2, 480x640, three frames of the odometry
                profile, Huber, bilinear bf16, "fused_gn") with the
                ImageWarped / Residual / Weights and SolverGN sinks on: one
                image per evaluated iteration and level in each sink, one
                sample launch per evaluation and no whole-level launch, the
                coarsest residual falling >= 10 %, pose error < 0.01; with
                the sinks off, 3 robust whole-level launches and a pose
                within 2e-2 of the recorded one
 12. times    — each new kernel's device ms (profiler) beside its plain
                version's and its bound at phase 10's level inputs, with
                the launch floor (a one-element zero_()'s device time, in
                the same profiler window; not a bound) beside every kernel
                and grid_sample beside the mxu kernel; align_pairs ms with
                "fused", "mxu" and "fused_gn"; RgbdAligner ms, sinks on and off
 13. split    — where an iteration of the whole-level kernel goes, both
                entries, at their level-0 main-path inputs (align_pairs
                B=64 F=1; the robust profile B=1 F=2): device time at
                max_iterations 1, 2, 4, 8 with the interest mask as given
                and thinned to every 8th point, fitted as launch +
                iterations x (fixed + per-point x points)
 14. sweep    — the whole-level kernel at each CTA count of CTAS_TRIED,
                each bit for bit against the plain version summing in that
                count's order, device ms at every level of the three paths
                that launch it (align_pairs, the odometry and the robust
                profile) with the evaluated iterations; the source's count
                is the chosen one
 15. mxu      — the mxu kernel against grid_sample at phase 10's level
                inputs in alternation (kernel, grid_sample, grid_sample,
                kernel; MXU_ROUNDS rounds) with the spread of each; then
                its split at each level: an empty kernel on its grid, the
                coordinates alone, the full kernel (builds of the source
                at each kMxuStage), beside the launch floor
 16. residual sweep — the NE kernel at each CTA count of NE_CTAS_TRIED
                (at every frame size) and each count of points in flight of
                NE_IN_FLIGHT_TRIED, beside the package's build (its cluster
                above kNeClusterPoints points), and the sampler at each
                count of points per thread of SAMPLE_PTS_TRIED, at phase
                10's inputs of every level: each bit for bit against its
                plain version (the NE's summing in that count's order),
                device ms per level, best of two runs in turns; the
                source's constants are the chosen ones
 17. pipeline — `OdometryPipeline` over the odometry profile's 64 frames
                as a TUM reader yields them (uint8 / uint16), production
                profile (`fused_gn`, bf16, 2048 points): the software-
                pipelined and the strict schedule, each with 3 x 63
                whole-level launches, ATE < 0.01 m, the same keyframes and
                per-frame poses within 2e-3 of each other; frames/s (two
                runs of each, in turns) and the host's waits per frame
                (torch's sync debug mode) of each;
                kernel 1 against its plain version at one frame's level-0
                inputs, bit for bit; host ms, launch calls and device-busy
                ms per frame under torch.profiler; 8 frames each with Huber
                (kernel 1b), `fused` quadratic (kernel 3) and Huber (kernel
                2), and `mxu` (kernel 4), one launch per evaluated
                iteration, and 16 frames of the default `gather`
                configuration, which launches no kernel; ATE < 0.01 m each;
                16 frames each with `enable_mapping` and with
                `enable_loop_closure` (the strict loop), ATE < 0.01 m
 18. CLI      — `python -m vslam_tpu_torch.eval.evaluate synthetic` at
                480x640 on the host loop and with --fused, each with and
                without --mapping (ATE < 0.01 m, landmarks with --mapping),
                then `evaluate`, `ate` and `rpe` on phase 17's trajectory
                (exit 0), and `odometry` on a TUM directory of PNG files
                (written here without PIL) where the port can read them
                (its native decoder or PIL; the output says which)
 19. sizes    — the robust entry on the 64 pairs' dense level 0 (F = 2,
                307,200 points a frame) with its residual cache in global
                scratch, Huber and Tukey, and the per-iteration sampler at
                70,000 (pair, frame) rows, above the grid's y extent; each
                bit for bit against its plain version
 20. KITTI    — `SequentialOdometry` with stereo depth over 32 rendered
                1241x376 pairs (`bench.py:1064-1110`: fx 718.856, baseline
                0.5372 m, 10 Hz, 4 levels, chunk 16, `fused_gn` bf16 2048
                points bilinear): the block matcher on the card against the
                CPU at the first pair; 4 x 31 whole-level launches and ATE
                < 0.25 m beside the JAX package's recorded 0.0035 m;
                frames/s staged and streamed; kernel 1 at each level's
                inputs (1241x376, 621x188, 311x94, 156x47: an odd size
                at every level) bit for bit
                against its plain version, with its device ms; under
                torch.profiler, the block matcher's device ms, launch
                calls and share of a step, and the peak memory
 21. suite    — `MultiSequenceOdometry` over S = 4 sequences of 32 frames
                at 480x640 (`bench.py:689-736`, the odometry profile): 3 x
                31 whole-level launches for all four, max ATE < 0.01 m on
                `run` and `run_staged`, each sequence within 1e-3 of its
                own `SequentialOdometry` run, kernel 1 at the suite's
                level-0 inputs (B = 4) bit for bit, aggregate frames/s
                beside 4 x the single sequence's; the same gates with
                sequence 3 cut to 24 frames (the live mask)
 22. aligners — the secondary aligners at 480x640 with their JAX tests'
                gates and their times: `RgbdAlignerFa` on two frames of the
                odometry profile, `IcpAligner` (both variants) on the JAX
                test's three-plane scene, `align_optical_flow` and
                `align_affine` (both methods) on the JAX tests' warped
                smooth image
 23. slam     — `SequentialOdometry` with `ChunkMappingBackend(enable_ba=
                True)` over 64 noisy 480x640 frames (`bench.py:787-916`):
                mapping off, a warm-up whose worker thread must touch the
                card 0 times (compute_device "auto"; CUDA ops counted by a
                dispatch mode on that thread), streamed and the best of 2
                `run_staged`, ATE < 0.01 m each; frames/s beside mapping
                off, the backend's host ms per chunk by stage and its share
                of the wall, the staged replay with compute_device
                "default", the detection's peak memory; kernel 1 at each
                level's inputs bit for bit
 24. slam_drift — 256 frames of the box orbit rendered on the card
                (`render_boxes_batch`, `bench.py:919-1045`), Huber nearest
                `fused_gn` (kernel 1b on the main path), BA + loop closure
                with pose_write_back "off": the JAX gate (closures >= 1,
                mapping-off ATE > 0.01 m, corrected < 0.6 x, online <= 1.02
                x); the worker's CUDA ops, counted in every 4th backend call
                (WORKER_OPS_EVERY; those calls must make a closure), 0;
                kernel 1b at each level's inputs bit for bit
 25. kitti_loop — 256 stereo pairs at 1241x376 of the street-scale loop
                rendered on the card (`bench.py:1165-1300`), the KITTI
                profile, BA + loop closure: the JAX gate (closures >= 1,
                mapping-off ATE > 0.02 m, corrected < 0.6 x); the graph
                solve's times and nodes, the stereo detection's peak memory;
                the worker's CUDA ops as in phase 24; kernel 1 at each
                level's inputs bit for bit
 26. graph    — the 900-node five-loop chain of the JAX test, solved on
                the card by PCG and by the dense 5400 x 5400 solve: gated in
                f64 (initial chi2 within rtol 1e-5, PCG's final chi2 < 0.1 x
                its initial, translations within 5e-3); the f32 solves at
                the production CG caps reported beside it (an open fault:
                PCG stalls there, as the JAX function does); both times, the
                CG iterations
 27. viewer and resume — (a) phase 23's streamed slam run with
                `LiveViz(port=0)`: /state.json holds 64 frames, the run's
                keyframes, its last pose (camera-in-world, within 1e-6) and
                the map's landmarks, / the page; 189 whole-level launches and
                every pose bit-equal to phase 23's run (the viewer only
                reads); frames/s with and without the viewer. (b) the
                odometry profile checkpointed after 32 frames and resumed in
                a fresh SequentialOdometry from a fresh state on the card: the stamps
                and every pose within 1e-4 of the uninterrupted run, 3 x 63
                launches, every loaded leaf on the card with its dtype; the
                file's size and the save and load ms; the slam run's
                landmarks through save_landmarks / load_landmarks. (c) phase
                17's 16 frames with enable_mapping and live_viz_port=0. (d)
                the CLI's synthetic with --live-viz 0 (host loop, --fused
                --mapping; ATE < 0.01 m) and odometry on two TUM directories
                with --live-viz 0 (the JAX CLI's warning, no viewer). (e)
                trace() around one chunk: the "viz.publish" span in
                trace.json; device_memory_stats() after (a)
 28. mesh     — (a) an NCCL group of one in this process on cuda:0:
                `sharded_tracking_step` on phase 6's 64 pairs (3 robust
                launches; ekf, rel and valid bit-equal to phase 6's, frac
                the mean of valid), `MultiSequenceOdometry(mesh=
                make_mesh())` on phase 21's streams, `run` and `run_staged`
                (3 x 31 launches each, every pose bit-equal to phase 21's
                run), `sharded_scan_sequences` on one chunk (bit-equal to
                `scan_sequences`), kernels 1 and 1b at this phase's level-0
                inputs bit for bit; pairs/s against phase 6's unsharded
                call, the all_reduce's host us. (b) MESH_RANKS processes
                sharing the card over gloo, loading phase 2's libraries:
                `sharded_tracking_step` (32 pairs a rank, rendered by the
                rank), `sharded_tracking_step_2d` on a (2, 1) mesh and
                `MultiSequenceOdometry(mesh=)` (S = 4, 2 a rank, lazy
                streams of which a rank renders its own), each rank's
                launches counted, every pair and pose within 1e-3 of (a)'s,
                frac equal; the largest difference and whether the results
                are bit-equal; the aggregate rate (two ranks on one card
                are not a scaling measurement)
 29. examples — each of the port's five examples (`examples/*_torch.py`)
                run in this process through its `main`, on cuda:0 and with
                --device cpu: robust_line_fit, ekf_motion_analysis and
                epipolar_lines print the same numbers on both to one unit
                of their 4th decimal, loop_closure_scaling (EXAMPLE_SIZES
                keyframes) the same query answers, with the card's rows
                printed; dataset_analysis (numpy only) on a TUM file of
                EXAMPLE_FRAMES poses; the kernel launches in the phase
 30. bench    — `python -m vslam_tpu_torch.bench` in a subprocess with the
                sub-benches of BENCH_OFF switched off (their paths run in
                phases 17, 20, 21, 24 and 25): exit 0, the expected keys
                and no `_error` or `_skipped` key, no rate of 0.0, the card
                as nvidia-smi names it, the whole-level kernel launched;
                the line and the phase's time logged;
                before it, the host's waits for the card in one headline
                call and in the rep loop (torch's sync debug mode); the
                subprocess's launches join the kernel line's counts
 31. frame build — the frame build kernel (`csrc/frame_build.cu`) at the
                suite's shapes, FB_FRAMES 480x640 uint8 + 16-bit depth at
                1/5000 m, 3 levels, against its plain version on the same
                tensors on the card, bit for bit (max_abs_err 0.0); its
                device ms (events, FB_REPS calls) beside its bound (the
                bytes read and written once at 3.35 TB/s) and the plain
                version's ms; the launches (one a level); the sweep of
                FB_SWEEP (blocks an SM at level 0 and above), each build
                bit for bit, device ms a level in turns. Its kernel line
                entry counts the launches of the main-path runs whose
                kernel-1 launches that line sums (phases 7, 11, 17, 20,
                21, 23-25, 27, 28, and phase 30's subprocess whole, as
                for kernel 1), from 0 at each reset; not phase 31's own
                nor a timing loop of this process
Every phase that runs a mapping backend (17, 18, 23-25, 27) fails on any
warning of the "mapping" logger (its graceful degradation hides nothing).
Phases 17-31 print their wall time. Phase 18's second half runs after
phase 21, on its frames and phase 20's: `odometry --format kitti` on a
KITTI root of 8 pairs (host loop, --fused, --fused --mapping), and a
repeated --dataset on two TUM directories (with and without --mapping) and
on two KITTI roots, each exit 0 with the ATE printed, where the port can
read PNG files.
The line before the last is a JSON object describing each kernel, with the
least time the card could take for its work (`_bound`); the last line is
{"ok": true, "device": {...}}. Any failed check raises, so the script
exits non-zero and prints no result. Imports neither jax nor vslam_tpu.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time
from typing import Any, Callable, NamedTuple

import numpy as np

H, W, FX = 480, 640, 525.0
B = 64
N_LEVELS = 3

# The card's published peaks (NVIDIA H100 SXM data sheet, dense, at the
# 700 W limit): f32 outside the tensor cores, and HBM3.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# f32 operations per point, counted from the sources: the SE(3) warp,
# projection and visibility test (warp_sample.cuh `warp_project`); a
# nearest or bilinear sample (`sample`); the residual and one point's Gram
# terms (`gram_accumulate`) or their weighted form
# (`gram_accumulate_weighted`); and sample_mxu.cu's floors, weights,
# in-image tests and mixes.
OPS_WARP = 32
OPS_SAMPLE = {"nearest": 4, "bilinear": 15}
OPS_GRAM = 58
OPS_GRAM_W = 65
OPS_MXU = 27
# The robust entry's scale and weight (fused_solve.cu), counted for the
# rounds this run's data needs (`_robust_scale_ops`): per point, the
# median's radix select takes OPS_SELECT_FIRST in its first round (key,
# digit, min, max) and, in each later round its frame takes part in,
# OPS_SELECT_KEY (the key) and OPS_SELECT_RANK for each rank still
# selecting (the prefix shift and test, the digit); per frame and median,
# OPS_REPLAY for the 24 bisection steps of two ranks replayed on one lane;
# per point and iteration, the absolute deviation sum of the reference
# scaler (OPS_ABSDEV) and the standardized residual and its weight
# (OPS_WEIGHT). OPS_ROBUST_BISECT is the scale's count per point and
# iteration for the 24 count passes of two ranks that a counting median
# makes, printed once beside it.
OPS_SELECT_FIRST = 5
OPS_SELECT_KEY = 2
OPS_SELECT_RANK = 3
OPS_REPLAY = 2 * 24 * 3
OPS_ABSDEV = 3
OPS_WEIGHT = 11
OPS_ROBUST_BISECT = 110
TAPS = {"nearest": 1, "bilinear": 4}  # pixels read per sample


def _sync():
    import torch

    torch.cuda.synchronize()


def _render_pairs(device, pairs=None, names=("ref", "mid", "cur")):
    """The bench's pairs: default_scene(seed=b), motion from default_rng(0)
    (translation +-0.01, rotation +-0.005), plus each pair's half-way frame
    for the stacked (F=2) case. ``pairs`` picks a block of the B pairs
    (the same images as in the whole batch); rendered on RENDER_THREADS
    host threads. Returns ({name: Frame}, xis of the block)."""
    import torch

    from vslam_tpu_torch.core import lie_np
    from vslam_tpu_torch.core.camera import Camera
    from vslam_tpu_torch.core.frame import create_frame
    from vslam_tpu_torch.io import synthetic

    pairs = range(B) if pairs is None else pairs
    K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    cam = Camera.create(FX, FX, (W - 1) / 2, (H - 1) / 2, device=device)
    rng = np.random.default_rng(0)
    xis = np.stack([np.concatenate([rng.uniform(-0.01, 0.01, 3), rng.uniform(-0.005, 0.005, 3)])
                    for _ in range(B)])[pairs.start:pairs.stop]
    pose = {"ref": lambda xi: np.eye(4), "mid": lambda xi: lie_np.exp(0.5 * xi), "cur": lie_np.exp}
    imgs = _render_all([lambda b=b, name=name: synthetic.render(K, pose[name](xis[b - pairs.start]), (H, W),
                                                                synthetic.default_scene(seed=b))
                        for name in names for b in pairs])
    frames = {}
    for k, name in enumerate(names):
        lst = imgs[k * len(pairs):(k + 1) * len(pairs)]
        inten = torch.as_tensor(np.stack([i for i, _ in lst]), device=device)
        depth = torch.as_tensor(np.stack([d for _, d in lst]), device=device)
        frames[name] = create_frame(inten, depth, cam, n_levels=N_LEVELS)
    return frames, xis


def _production_cfg():
    from vslam_tpu_torch.alignment.ic import AlignmentConfig
    from vslam_tpu_torch.solvers import SolverConfig

    return AlignmentConfig(
        min_gradient=30.0,
        solver=SolverConfig(max_iterations=100, min_step_size=1e-11, min_relative_reduction=1e-4),
        include_prior=True,
        interpolation="nearest",
        sampler="fused_gn",
        image_dtype="bfloat16",
        max_points=2048,
    )


def _pose_dist(a, b):
    """Per-pair ||log(a^-1 b)|| in float64, a and b SE3 with leaves (B, ...)."""
    from vslam_tpu_torch.core import se3
    from vslam_tpu_torch.core.se3 import SE3

    a64 = SE3(a.R.double(), a.t.double())
    b64 = SE3(b.R.double(), b.t.double())
    return se3.log(se3.compose(se3.inverse(a64), b64)).norm(dim=-1)


def _events_ms(fn, reps):
    """Mean ms per call over ``reps`` calls, CUDA events around the run."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# profiler windows tried before a measurement fails: the card's profiler
# (CUPTI) now and then delivers none of a window's kernel records
PROFILER_ATTEMPTS = 3


def _profiled_events(fn):
    """The events of one torch.profiler window around ``fn()``, which ends
    synchronized; a short pause before the window closes lets the profiler
    deliver the device records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        time.sleep(0.01)
    return prof.events()


def _kernel_device_ms(fn, reps, kernel_name):
    """(mean device ms per launch, records seen) of the one kernel named
    ``kernel_name`` that each call of ``fn`` launches, from a torch.profiler
    (CUPTI) window over ``reps`` calls. Unlike events around the calls, this
    excludes the host time of the wrapper, which bounds small levels. The
    profiler does not always deliver every kernel record (on the card it
    has missed one or two of 20, and now and then all of them), so the mean
    is over the records it delivered, of identical launches; at least half
    must arrive, in one of PROFILER_ATTEMPTS windows."""
    from torch.autograd import DeviceType

    for _ in range(PROFILER_ATTEMPTS):
        events = _profiled_events(lambda: [fn() for _ in range(reps)])
        us = [e.time_range.end - e.time_range.start for e in events
              if e.device_type == DeviceType.CUDA and kernel_name in e.name]
        if reps // 2 <= len(us) <= reps:
            return sum(us) / 1e3 / len(us), len(us)
    raise AssertionError(f"profiler saw {len(us)} launches of {kernel_name}, expected {reps}, "
                         f"in each of {PROFILER_ATTEMPTS} windows")


def _device_ms_batch(groups):
    """Device ms of several measurements in one torch.profiler window (the
    card's profiler has dropped every record after many windows in one
    process). Each group (fn, reps, kernel_name) runs its reps calls inside
    a record_function range that ends in a synchronization, the groups 2 ms
    apart; its time is the
    mean over the recorded device kernels in the range whose name holds
    kernel_name (per launch; at least half of reps recorded), or, for
    kernel_name None, every device kernel in the range summed over reps (a
    library call's time per call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    def window():
        for g, (fn, reps, _) in enumerate(groups):
            with record_function(f"_group{g}"):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            time.sleep(2e-3)  # an idle gap: device and host clocks align only to a few us

    for fn, _, _ in groups:
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_ATTEMPTS):
        events = _profiled_events(window)
        ranges = {e.name: (e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == DeviceType.CPU and e.name.startswith("_group")}
        kernels = [e for e in events if e.device_type == DeviceType.CUDA and not e.name.startswith("_group")]
        out, missing = [], None
        for g, (_, reps, name) in enumerate(groups):
            a, b = ranges[f"_group{g}"]
            inside = [e for e in kernels if a <= e.time_range.start <= b]
            us = [e.time_range.end - e.time_range.start for e in inside if name is None or name in e.name]
            if not (us if name is None else reps // 2 <= len(us) <= reps):
                missing = (f"profiler saw {len(us)} launches of {name or 'any kernel'} in group {g}, "
                           f"expected {reps} (kernels seen: {sorted({e.name for e in inside})[:5]})")
                break
            out.append(sum(us) / 1e3 / (reps if name is None else len(us)))
        if missing is None:
            return out
    raise AssertionError(f"{missing}, in each of {PROFILER_ATTEMPTS} windows")


def _calls_device_ms(fn, reps):
    """(device ms per call of every kernel ``fn`` launches, their names)
    from a torch.profiler window over ``reps`` calls: the time of a library
    call whose kernels are not ours to name."""
    from torch.autograd import DeviceType

    fn()
    for _ in range(PROFILER_ATTEMPTS):
        events = [e for e in _profiled_events(lambda: [fn() for _ in range(reps)])
                  if e.device_type == DeviceType.CUDA]
        if events:
            us = sum(e.time_range.end - e.time_range.start for e in events)
            return us / 1e3 / reps, sorted({e.name for e in events})
    raise AssertionError(f"profiler saw no device kernel of the library call in {PROFILER_ATTEMPTS} windows")


@contextlib.contextmanager
def _tap(module, name, sink):
    """While the block runs, hand (args, result) of every call of
    ``module.name`` to ``sink``; the port's callers look the function up on
    its module at each call."""
    fn = getattr(module, name)

    def tapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        sink(args, out)
        return out

    setattr(module, name, tapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


def _max_abs_diff(got, want) -> float:
    """Largest |got - want| over a tensor or a tuple of tensors (bool as
    0 / 1); inf where shapes or NaN positions differ."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for a, b in zip(got, want, strict=True):
        if a.shape != b.shape:
            return float("inf")
        a, b = a.double(), b.double()
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            return float("inf")
        if a.numel():
            err = max(err, (a - b).abs().nan_to_num(0.0).max().item())
    return err


def _bound(ops: float, nbytes: float):
    """(least ms the card could take, "operations" or "bytes") for ``ops``
    f32 operations and ``nbytes`` bytes, each input read once and each
    output written once, at the published peaks."""
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def _point_bytes(data, with_ne: bool) -> int:
    """Bytes of the level data a residual pass reads once: per point pcl
    and mask (and J and the template for the NE), per frame the pose, per
    pair the camera."""
    Bp, F, P = data.mask.shape
    return Bp * F * P * (13 + (28 if with_ne else 0)) + Bp * F * 48 + Bp * 16


def _solve_work(args, result, scale_ops=None):
    """(operations, bytes) one whole-level launch needs at these inputs:
    each evaluated (pair, iteration) warps, samples and accumulates the
    pair's interest points and reads their pixel taps; the level data,
    prior and outputs move once. The robust entry adds ``scale_ops`` for
    its scales and weights (default: what `_robust_scale_ops` counts)."""
    data, _, image, _, cfg, _ = args
    Bp, F, _ = data.mask.shape
    point_evals = _point_evals(args, result)
    ops = point_evals * (OPS_WARP + OPS_SAMPLE[cfg.interpolation])
    if cfg.loss.function == "None":
        ops += point_evals * OPS_GRAM
    else:
        ops += point_evals * OPS_GRAM_W + (_robust_scale_ops(args, result) if scale_ops is None else scale_ops)
    bpp = 2 if cfg.image_dtype == "bfloat16" else 4
    taps = min(point_evals * TAPS[cfg.interpolation], image.numel()) * bpp
    n_it = result.chi2_history.shape[1]
    nbytes = _point_bytes(data, True) + Bp * F * 28 + taps + Bp * 4 * (64 + 2 * n_it)
    return ops, nbytes


def _point_evals(args, result) -> float:
    """Interest points times evaluated iterations, summed over the pairs."""
    import torch

    evals = torch.isfinite(result.chi2_history).sum(dim=1).double()
    return float((evals * args[0].mask.sum(dim=(1, 2)).double()).sum())


def _float_keys(x):
    """fused_solve.cu's order-preserving uint32 keys of non-NaN floats."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return np.where(u >> 31 == 1, ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def _rank_rounds(keys, k: int) -> int:
    """Rounds of the kernel's radix select for the k-th of the sorted
    ``keys``: done after the first round whose bucket (the keys that share
    the selected digits) holds no key with other lower bits than the
    canonical ones (zeros above zero, ones below), at the latest after 4."""
    key = int(keys[k])
    for r in range(3):
        low = 24 - 8 * r
        bucket = keys[(keys >> low) == (key >> low)]
        canonical = np.where(bucket >> 31 == 1, 0, (1 << low) - 1).astype(np.uint32)
        if np.all((bucket & np.uint32((1 << low) - 1)) == canonical):
            return r + 1
    return 4


def _select_point_ops(v, m, n):
    """Operations per interest point (B, F) of one masked median of v
    (B, F, P) over m, ranks from n (B, F), as the kernel's radix select
    takes them (`select_medians`)."""
    v, m, n = v.cpu().numpy(), m.cpu().numpy(), n.cpu().numpy()
    out = np.zeros(n.shape)
    for idx in np.ndindex(*n.shape):
        x = v[idx][m[idx]]
        keys = np.sort(_float_keys(x[~np.isnan(x)]))
        ranks = (max(np.floor((n[idx] - 1.0) * 0.5), 0.0), max(np.floor(n[idx] * 0.5), 0.0))
        rounds = [_rank_rounds(keys, int(k)) if k < len(keys) else 1 for k in ranks]
        ops = OPS_SELECT_FIRST
        for r in range(1, 4):
            live = sum(n_rounds > r for n_rounds in rounds)
            ops += OPS_SELECT_KEY + OPS_SELECT_RANK * live if live else 0
        out[idx] = ops
    return out


def _robust_scale_ops(args, result) -> float:
    """f32 operations of the robust entry's scales and weights in one launch
    at ``args`` (median scalers; ``result`` the kernel's), counted for what
    this data needs: the plain version, bit-equal with the kernel, is run
    at ``args``, and each median it takes while a pair is still iterating
    is counted as the kernel's radix select takes it, with the rounds each
    frame takes part in and the ranks still selecting in each."""
    import torch

    from vslam_tpu_torch.alignment import fused_solve

    data, cfg = args[0], args[4]
    if cfg.loss.function == "tdistribution" or cfg.loss.scaler == "mean":
        raise ValueError("_robust_scale_ops counts the median scalers only")
    calls = []
    with _tap(fused_solve, "_bisect_median", lambda a, _: calls.append(a)):
        fused_solve.solve_level_fused_plain(*args)
    evals = torch.isfinite(result.chi2_history).sum(dim=1).cpu().numpy()
    per_iteration = len(calls) // max(int(evals.max()), 1)
    points = data.mask.sum(dim=-1).double().cpu().numpy()  # (B, F)
    ops = 0.0
    for c, (v, m, n) in enumerate(calls):
        live = (evals > c // per_iteration)[:, None]
        ops += float(((_select_point_ops(v, m, n) * points + OPS_REPLAY) * live).sum())
    per_point = OPS_WEIGHT + (OPS_ABSDEV if cfg.loss.scaler == "reference" else 0)
    return ops + float((evals * points.sum(axis=1)).sum()) * per_point


def _sample_work(args, out):
    """(operations, bytes) of one fused_level_sample launch: every interest
    point warped, every visible one sampled."""
    data, _, image, _, interp = args
    n_vis = float(out[1].sum())
    ops = float(data.mask.sum()) * OPS_WARP + n_vis * OPS_SAMPLE[interp]
    taps = min(n_vis * TAPS[interp], image.numel()) * image.element_size()
    return ops, _point_bytes(data, False) + taps + data.mask.numel() * 5


def _ne_work(args, out):
    """(operations, bytes) of one fused_level_ne launch: every interest
    point warped, every visible one sampled and accumulated."""
    data, _, image, _, interp = args
    n_vis = float(out[3].sum())
    ops = float(data.mask.sum()) * OPS_WARP + n_vis * (OPS_SAMPLE[interp] + OPS_GRAM)
    taps = min(n_vis * TAPS[interp], image.numel()) * image.element_size()
    return ops, _point_bytes(data, True) + taps + out[3].numel() * 44 * 4


def _mxu_work(args, out):
    """(operations, bytes) of one bilinear_sample_mxu launch: u, v and the
    sample per point, four taps each."""
    img, u, _ = args
    n = u.numel()
    return n * OPS_MXU, n * 12 + min(4 * n, img.numel()) * 4


class _Kernel(NamedTuple):
    wrapper: Callable
    plain: Callable
    module: Any  # holds the wrapper and its launch count
    counter: str
    cuda_name: str  # the __global__ function, as the profiler names it
    image_arg: int  # position of the image among the wrapper's arguments
    work: Callable  # (args, result) -> (operations, bytes)
    source: str
    replaces: str


def _new_kernels():
    """The per-iteration kernels of phases 9-12, by name."""
    from vslam_tpu_torch.alignment import fused_ne, pallas_kernels as pk

    src = "vslam_tpu_torch/csrc/"
    return {
        "fused_level_sample": _Kernel(
            fused_ne.fused_level_sample, fused_ne.fused_level_sample_plain, fused_ne,
            "SAMPLE_LAUNCHES", "sample_level_kernel", 2, _sample_work, src + "fused_ne.cu",
            "vslam_tpu/alignment/fused_ne.py:312"),
        "fused_level_ne": _Kernel(
            fused_ne.fused_level_ne, fused_ne.fused_level_ne_plain, fused_ne, "NE_LAUNCHES",
            "level_ne_kernel", 2, _ne_work, src + "fused_ne.cu", "vslam_tpu/alignment/fused_ne.py:252"),
        "bilinear_sample_mxu": _Kernel(
            pk.bilinear_sample_mxu, pk.bilinear_sample_mxu_plain, pk, "MXU_LAUNCHES",
            "sample_mxu_kernel", 0, _mxu_work, src + "sample_mxu.cu",
            "vslam_tpu/alignment/pallas_kernels.py:37"),
    }


def _level0_problems(frames, xis, device):
    """The finest level of the 64 pairs as F=1 (reference frame) and F=2
    (reference and half-way frame, predicted at the half-way pose) data."""
    import torch

    from vslam_tpu_torch.alignment import ic
    from vslam_tpu_torch.alignment.aligner import stack_frames
    from vslam_tpu_torch.core import se3
    from vslam_tpu_torch.core.se3 import SE3

    base = _production_cfg()
    level = 0
    eye = SE3(torch.eye(3, device=device).expand(B, 1, 3, 3).contiguous(),
              torch.zeros(B, 1, 3, device=device))
    ref1 = frames["ref"]
    data1 = ic.precompute_level(ref1.intensity[level][:, None], ref1.dIx[level][:, None],
                                ref1.dIy[level][:, None], ref1.depth[level][:, None],
                                ref1.cameras[level], base.min_gradient, max_points=base.max_points)
    ref2 = stack_frames([frames["ref"], frames["mid"]], dim=1)
    data2 = ic.precompute_level(ref2.intensity[level], ref2.dIx[level], ref2.dIy[level],
                                ref2.depth[level], ref1.cameras[level], base.min_gradient,
                                max_points=base.max_points)
    mid_pose = se3.exp(torch.as_tensor(0.5 * xis, dtype=torch.float32, device=device))
    rel2 = SE3(torch.stack([mid_pose.R, torch.eye(3, device=device).expand(B, 3, 3)], 1),
               torch.stack([mid_pose.t, torch.zeros(B, 3, device=device)], 1))
    return {"cfg": base, "f1": (data1, eye, torch.zeros(B, 1, 6, device=device)),
            "f2": (data2, rel2, se3.log(rel2))}


def _check(out_k, out_p, pose_tol, log, what):
    """One kernel result against its plain version's on the same CUDA
    tensors: valid equal, iterations within 1, pose distance (every
    stacked frame) below ``pose_tol``, A within 1e-3 of max|A|. Returns
    (max abs pose-entry difference, passed)."""
    import torch

    from vslam_tpu_torch.core.se3 import SE3

    (rel_k, res_k), (rel_p, res_p) = out_k, out_p
    _sync()
    n_pairs = res_k.valid.shape[0]
    valid_eq = torch.equal(res_k.valid, res_p.valid)
    it_abs = (res_k.iterations - res_p.iterations).abs()
    flat = lambda r: SE3(r.R.reshape(n_pairs, -1, 3, 3), r.t.reshape(n_pairs, -1, 3))  # noqa: E731
    dists = _pose_dist(flat(rel_k), flat(rel_p)).amax(dim=1)
    scale = res_p.A.abs().amax(dim=(1, 2))
    a_rels = (res_k.A - res_p.A).abs().amax(dim=(1, 2)) / scale
    err = max((rel_k.R - rel_p.R).abs().max().item(), (rel_k.t - rel_p.t).abs().max().item())
    it_diff, dist, a_rel = it_abs.max().item(), dists.max().item(), a_rels.max().item()
    log(f"{what}: valid equal {valid_eq} ({int(res_k.valid.sum())}/{n_pairs}), "
        f"iterations max diff {it_diff} (limit 1; mean {res_k.iterations.float().mean().item():.2f}, "
        f"pairs differing {int((it_abs > 0).sum())}), pose dist max {dist:.3e} (limit "
        f"{pose_tol:g}), A max diff {a_rel:.3e} of max|A| (limit 1e-3), max_abs_err {err:.3e}")
    ok = valid_eq and it_diff <= 1 and dist < pose_tol and a_rel < 1e-3
    if not ok:
        b = int(torch.argmax(it_abs.float() + dists / pose_tol + a_rels / 1e-3))
        n = int(max(res_k.iterations[b], res_p.iterations[b])) + 2
        log(f"  worst pair {b}: iterations kernel {int(res_k.iterations[b])} plain "
            f"{int(res_p.iterations[b])}, dist {dists[b].item():.3e}, A {a_rels[b].item():.3e}")
        for lbl, res in (("kernel", res_k), ("plain", res_p)):
            log(f"  {lbl} chi2 {res.chi2_history[b, :n].tolist()}")
            log(f"  {lbl} step {res.step_history[b, :n].tolist()}")
    return err, ok


def _compare(cases, frames, log, label):
    """Each case's kernel and plain version on the same CUDA tensors, held
    by `_check`. Returns (max abs pose-entry difference, failed case
    names)."""
    from vslam_tpu_torch.alignment import fused_solve

    level = 0
    img = frames["cur"].intensity[level]
    cam = frames["cur"].cameras[level]
    max_abs = 0.0
    failures = []
    for name, cfg, (data, rel0, xp), pose_tol in cases:
        err, ok = _check(fused_solve.solve_level_fused(data, rel0, img, cam, cfg, xp),
                         fused_solve.solve_level_fused_plain(data, rel0, img, cam, cfg, xp),
                         pose_tol, log, f"{label} vs plain [{name}]")
        max_abs = max(max_abs, err)
        if not ok:
            failures.append(name)
    return max_abs, failures


def _kernel_vs_plain(problems, frames, log):
    """Phase 3: the quadratic entry, four cases."""
    import dataclasses

    base = problems["cfg"]
    f32 = dataclasses.replace(base, image_dtype="float32")
    cases = [
        ("F=1 nearest bf16", base, problems["f1"], 1e-3),
        ("F=1 nearest f32", f32, problems["f1"], 1e-4),
        ("F=2 prior nearest f32", f32, problems["f2"], 1e-4),
        ("F=1 bilinear f32", dataclasses.replace(f32, interpolation="bilinear"), problems["f1"], 1e-4),
    ]
    return _compare(cases, frames, log, "kernel")


ROBUST_CASES = [("Huber", "reference"), ("Tukey", "reference"), ("tdistribution", "reference"),
                ("Huber", "mad"), ("Tukey", "mad"), ("Huber", "mean"), ("Tukey", "mean")]


def _robust_vs_plain(problems, frames, log):
    """Phase 4: the robust entry, the 7 loss x scaler cases and Huber F=2."""
    import dataclasses

    from vslam_tpu_torch.solvers import LossConfig

    base = problems["cfg"]
    cases = [(f"{fn}/{sc} F=1 nearest f32",
              dataclasses.replace(base, image_dtype="float32", loss=LossConfig(fn, scaler=sc)),
              problems["f1"], 1e-4) for fn, sc in ROBUST_CASES]
    cases.append(("Huber/reference F=2 prior nearest bf16",
                  dataclasses.replace(base, loss=LossConfig("Huber")), problems["f2"], 1e-3))
    return _compare(cases, frames, log, "robust kernel")


def _level_inputs(frames, cfg, rel_init, x_pred):
    """Walk ic.align's coarse-to-fine loop, recording each level's
    precompute and solve inputs (the shapes and states the main path gives
    the kernel)."""
    from vslam_tpu_torch.alignment import ic
    from vslam_tpu_torch.core.se3 import SE3
    from vslam_tpu_torch.utils.tree import tree_map

    ref = tree_map(lambda x: x[:, None], frames["ref"])
    cur = frames["cur"]
    rel = SE3(rel_init.R[:, None], rel_init.t[:, None])
    xp = x_pred[:, None]
    out = {}
    for level in range(N_LEVELS - 1, -1, -1):
        pre = (ref.intensity[level], ref.dIx[level], ref.dIy[level], ref.depth[level],
               ic._first_camera(ref.cameras[level], B), cfg.min_gradient,
               cfg.max_points >> (2 * level))
        args = (ic.precompute_level(*pre), rel, cur.intensity[level], cur.cameras[level], cfg, xp)
        out[level] = pre, args
        rel, _ = ic.solve_level(*args)
    return out


def _device_busy(events):
    """(CUDA kernels, device-busy ms as the union of their intervals) among
    a profiler's events."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -float("inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return len(spans), busy / 1e3


def _pair_errors(rel, xis):
    """Per-pair ||log(T_est) - xi_true|| on the host, T_est re-orthonormalized."""
    from vslam_tpu_torch.core import lie_np

    R_all, t_all = rel.R.double().cpu().numpy(), rel.t.double().cpu().numpy()
    errs = []
    for b in range(len(xis)):
        T = np.eye(4)
        u, _, vt = np.linalg.svd(R_all[b])
        T[:3, :3] = u @ vt
        T[:3, 3] = t_all[b]
        errs.append(np.linalg.norm(lie_np.log(T) - xis[b]))
    return np.asarray(errs)


def _reset_launches():
    """Every kernel wrapper's launch count to 0."""
    from vslam_tpu_torch.alignment import fused_ne, fused_solve, pallas_kernels
    from vslam_tpu_torch.core import frame_build

    fused_solve.LAUNCHES = fused_solve.ROBUST_LAUNCHES = 0
    fused_ne.SAMPLE_LAUNCHES = fused_ne.NE_LAUNCHES = 0
    pallas_kernels.MXU_LAUNCHES = 0
    frame_build.FRAME_BUILD_LAUNCHES = 0


# phase: the frame build's launches in its counted main-path runs (the
# runs whose kernel-1 launches the kernel line sums), for that line
FRAME_BUILDS = {}


def _frame_builds(phase):
    """Adds the frame build's launches since the reset to FRAME_BUILDS."""
    from vslam_tpu_torch.core import frame_build

    FRAME_BUILDS[phase] = FRAME_BUILDS.get(phase, 0) + frame_build.FRAME_BUILD_LAUNCHES


def _launches():
    """(quadratic-entry launches, robust-entry launches) since the reset."""
    from vslam_tpu_torch.alignment import fused_solve

    return fused_solve.LAUNCHES - fused_solve.ROBUST_LAUNCHES, fused_solve.ROBUST_LAUNCHES


ODO_FRAMES = 64
DT_NS = int(1e9 / 30)
# name: (chunk, ATE gate in metres, kernel entry the profile runs)
PROFILES = {"odometry": (32, 0.01, "quadratic"), "robust": (16, 0.02, "robust")}


def _odometry_streams(profiles=tuple(PROFILES), n=ODO_FRAMES):
    """The two sequential profiles' 480x640 streams in the sensor dtypes
    (uint8 intensity, uint16 depth at 1/5000 m) with their ground truth,
    the first ``n`` frames of each: `bench.py:555-586` (smooth trajectory
    on the plane scene, re-based on frame 0) and `bench.py:965-986` cut to
    the first 64 of its 256 frames (orbit on the box scene, seed 4)."""
    from vslam_tpu_torch.core import lie_np
    from vslam_tpu_torch.io import synthetic

    K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)

    def encode(images):
        return [(i * DT_NS, np.clip(np.round(inten), 0, 255).astype(np.uint8),
                 np.clip(np.round(depth * 5000.0), 0, 65535).astype(np.uint16))
                for i, (inten, depth) in enumerate(images)]

    out = {}
    if "odometry" in profiles:
        smooth = synthetic.smooth_trajectory(ODO_FRAMES, trans_amp=0.08, rot_amp=0.03)
        p0i = lie_np.inv(smooth[0])
        smooth = [p @ p0i for p in smooth][:n]
        out["odometry"] = (smooth, encode(synthetic.render(K, p, (H, W)) for p in smooth))
    if "robust" in profiles:
        scene = synthetic.BoxScene(seed=4)
        orbit = synthetic.orbit_trajectory(256, radius=0.4, height=0.05, yaw=0.12)[:min(n, ODO_FRAMES)]
        out["robust"] = (orbit, encode(synthetic.render_boxes(K, p, (H, W), scene) for p in orbit))
    return out


def _odometry_cfg(profile):
    """The bench's sequential configs: the production alignment profile with
    bilinear sampling (odometry) or the Huber loss (robust)."""
    import dataclasses

    from vslam_tpu_torch.odometry.sequential import SequentialConfig
    from vslam_tpu_torch.solvers import LossConfig

    align = _production_cfg()
    if profile == "odometry":
        align = dataclasses.replace(align, interpolation="bilinear")
    else:
        align = dataclasses.replace(align, loss=LossConfig("Huber"))
    return SequentialConfig(alignment=align, depth_scale=1.0 / 5000.0, n_levels=N_LEVELS, kf_period=5)


def _ate(poses, results):
    from vslam_tpu_torch.core import lie_np
    from vslam_tpu_torch.eval import metrics

    gt = {i * DT_NS / 1e9: lie_np.inv(p) for i, p in enumerate(poses)}
    est = {t / 1e9: lie_np.inv(p) for t, p, _ in results}
    ate, n = metrics.ate_rmse(gt, est)
    if n != len(poses):
        raise AssertionError(f"ATE associated {n} of {len(poses)} frames")
    return float(ate)


def _run_profile(profile, poses, stream, camera, log):
    """Phase 7, one profile: the counted run of the main path."""
    from vslam_tpu_torch.odometry.sequential import SequentialOdometry

    chunk, gate, entry = PROFILES[profile]
    odo = SequentialOdometry(camera, _odometry_cfg(profile), chunk=chunk)
    _reset_launches()
    results = odo.run(iter(stream))
    _sync()
    quad, robust = _launches()
    _frame_builds(f"7 {profile}")
    ate = _ate(poses, results)
    n_valid = sum(odo.valid)
    log(f"{profile} profile: {len(results)} frames at {H}x{W}, chunk {chunk}; launches quadratic "
        f"{quad} robust {robust} (expected {3 * (ODO_FRAMES - 1)} {entry}); valid {n_valid}/"
        f"{len(results)}, keyframes {sum(odo.is_kf)}; ATE {ate:.5f} m (gate {gate})")
    want = (3 * (ODO_FRAMES - 1), 0) if entry == "quadratic" else (0, 3 * (ODO_FRAMES - 1))
    if (quad, robust) != want:
        raise AssertionError(f"{profile} profile: launches {(quad, robust)}, expected {want}")
    if profile == "robust" and n_valid != len(results):
        raise AssertionError(f"robust profile: {len(results) - n_valid} frames not valid")
    if not ate < gate:
        raise AssertionError(f"{profile} profile: ATE {ate} m, gate {gate} m")
    return quad + robust, ate


def _frame_layers(odo, first, chunk, n_steps, extra=()):
    """One profiled `run_staged` of ``first`` and ``chunk``, with a
    `record_function` range around each odometry step and, inside it, the
    frame build, the precompute, the alignment and the ``extra`` (module,
    attribute, label) layers. Returns (per step:
    {layer: (host ms, CUDA launch calls)} with the rest of the step as a
    layer of its own, host ms outside the steps (first frame, fetch),
    device kernels, device-busy ms, profiled wall ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from vslam_tpu_torch.alignment import ic
    from vslam_tpu_torch.odometry import sequential as seq

    def ranged(label, fn):
        def call(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return call

    patches = [(seq, "_step", "step"), (seq, "create_frame", "frame build"),
               (ic, "precompute_frame", "precompute"), (ic, "align", "align"), *extra]
    originals = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for mod, attr, label in patches:
        setattr(mod, attr, ranged(label, getattr(mod, attr)))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            odo.run_staged(first, [chunk])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)
    labels = [label for _, _, label in patches]
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    spans = {label: [(e.time_range.start, e.time_range.end) for e in host if e.name == label]
             for label in labels}
    if len(spans["step"]) != n_steps:
        raise AssertionError(f"profiler saw {len(spans['step'])} step ranges, expected {n_steps}")
    inside = lambda t, sp: any(a <= t <= b for a, b in sp)  # noqa: E731
    launch_calls = [e.time_range.start for e in host
                    if e.name.startswith(("cudaLaunch", "cuLaunch")) and inside(e.time_range.start, spans["step"])]
    out = {}
    for label in labels:  # the first frame's build and precompute run outside the steps
        sp = [(a, b) for a, b in spans[label] if inside(a, spans["step"])]
        out[label] = (sum(b - a for a, b in sp) / 1e3 / n_steps,
                      sum(1 for t in launch_calls if inside(t, sp)) / n_steps)
    out["rest of the step"] = tuple(out["step"][i] - sum(out[k][i] for k in labels[1:]) for i in (0, 1))
    outside = wall - out["step"][0] * n_steps
    # a range's device-side annotation is not a kernel
    return (out, outside, *_device_busy(e for e in events if e.name not in labels), wall)


def _time_profile(profile, stream, camera, card, log):
    """Phase 8, one profile: frames/s staged (best of 2 after a warm-up) and
    streamed (best of 2), and, at the solve inputs of the last frame of the
    first chunk, each level's kernel held against the plain version and its
    device ms beside the plain version's. Returns (kernel ms, plain ms) by
    level, the kernel's largest pose-entry difference from the plain
    version, a function that prints the layers of a frame and the
    device-busy share under the profiler, and (bound ms, what bounds it)
    of the three solves."""
    from vslam_tpu_torch.alignment import fused_solve
    from vslam_tpu_torch.odometry.sequential import SequentialOdometry, stage_stream

    chunk, _, entry = PROFILES[profile]
    cfg = _odometry_cfg(profile)
    first, chunks = stage_stream(iter(stream), chunk)
    odo = SequentialOdometry(camera, cfg, chunk=chunk)
    odo.run_staged(first, chunks)
    staged, streamed = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        odo.run_staged(first, chunks)
        staged.append(time.perf_counter() - t0)
    for _ in range(2):
        t0 = time.perf_counter()
        SequentialOdometry(camera, cfg, chunk=chunk).run(iter(stream))
        streamed.append(time.perf_counter() - t0)
    n = len(stream)
    fps, fps_stream = n / min(staged), n / min(streamed)
    log(f"{profile} profile: run_staged {fps:.2f} frames/s (best of {', '.join(f'{t:.3f}' for t in staged)} s "
        f"for {n} frames), run {fps_stream:.2f} frames/s (best of "
        f"{', '.join(f'{t:.3f}' for t in streamed)} s) {card}")

    captured = _profile_solve_inputs(odo, first, chunks)
    pose_tol = 1e-3 if cfg.alignment.image_dtype == "bfloat16" else 1e-4
    ms_k, ms_p = {}, {}
    max_abs, failures, work, work_bisect = 0.0, [], np.zeros(2), np.zeros(2)
    scale_ops, point_evals = 0.0, 0.0
    for level, args in enumerate(captured):
        run_k = lambda: fused_solve.solve_level_fused(*args)  # noqa: E731
        run_p = lambda: fused_solve.solve_level_fused_plain(*args)  # noqa: E731
        out_k = run_k()
        if entry == "robust":
            level_scale = _robust_scale_ops(args, out_k[1])
            scale_ops, point_evals = scale_ops + level_scale, point_evals + _point_evals(args, out_k[1])
            work += _solve_work(args, out_k[1], level_scale)
            work_bisect += _solve_work(args, out_k[1], _point_evals(args, out_k[1]) * OPS_ROBUST_BISECT)
        else:
            work += _solve_work(args, out_k[1])
        err, ok = _check(out_k, run_p(), pose_tol, log,
                         f"{profile} profile level {level} {entry} kernel vs plain at the main path's inputs")
        max_abs = max(max_abs, err)
        if not ok:
            failures.append(level)
        p1 = _events_ms(run_p, 2)
        k1 = _events_ms(run_k, 20)
        p2 = _events_ms(run_p, 2)
        ms_p[level] = min(p1, p2)
        ms_k[level], seen = _kernel_device_ms(run_k, 20, "solve_level_kernel")
        log(f"{profile} profile level {level} ({args[2].shape[-2]}x{args[2].shape[-1]}, F={args[0].templ.shape[1]}, "
            f"P={args[0].templ.shape[-1]}, {entry} entry): kernel {ms_k[level]:.4f} ms on the device "
            f"(profiler, mean of {seen} recorded of 20 launches), wrapper call {k1:.4f} ms, plain {ms_p[level]:.3f} ms (events, "
            f"runs plain,kernel,plain: {p1:.3f}, {k1:.4f}, {p2:.3f}) {card}")
    if failures:
        raise AssertionError(f"{profile} profile: kernel and plain disagree at levels {failures}")
    if entry == "robust":
        (b_new, by_new), (b_old, by_old) = _bound(*work), _bound(*work_bisect)
        log(f"{profile} profile bound over 3 levels: {b_new:.6f} ms ({by_new}) with this design's "
            f"scale as this run's data needs it ({scale_ops:.0f} operations, "
            f"{scale_ops / max(point_evals, 1.0):.2f} per point and iteration), {b_old:.6f} ms ({by_old}) "
            f"with the 24-pass bisection's {OPS_ROBUST_BISECT} per point and iteration")
    frame_ms = 1e3 / fps

    def layers():
        k = len(chunks[0].stamps)
        split, outside, n_kernels, busy_ms, wall = _frame_layers(odo, first, chunks[0], k)
        n1 = k + 1
        log(f"{profile} profile under torch.profiler, run_staged of the first chunk ({n1} frames): "
            f"{n_kernels / n1:.1f} device kernels per frame, device busy {busy_ms / n1:.3f} ms per "
            f"frame = {busy_ms / wall:.3f} of the profiled wall ({wall / n1:.3f} ms per frame) and "
            f"{busy_ms / n1 / frame_ms:.3f} of the unprofiled staged frame time ({frame_ms:.3f} ms) {card}")
        parts = ", ".join(f"{name} {ms:.3f} ms / {n:.1f} launch calls" for name, (ms, n) in split.items())
        log(f"{profile} profile layers per step, host time under torch.profiler (mean of {k} steps): "
            f"{parts}; outside the steps (first frame, fetch) {outside / k:.3f} ms per step {card}")

    return ms_k, ms_p, max_abs, layers, _bound(*work), captured


def _profile_solve_inputs(odo, first, chunks):
    """The solve inputs the main path gives the kernel: those of the last
    frame of the first chunk, one argument tuple per level, finest first."""
    from vslam_tpu_torch.alignment import fused_solve

    captured = {}
    with _tap(fused_solve, "solve_level_fused", lambda args, _: captured.__setitem__(args[2].shape[-1], args)):
        odo.run_staged(first, chunks[:1])
    _sync()
    return [captured[w] for w in sorted(captured, reverse=True)]


SPLIT_ITERATIONS = (1, 2, 4, 8)


def _solve_split(args, label, card, log):
    """Where an iteration of the whole-level kernel goes, at one level's
    inputs: device ms (profiler, 20 launches) with max_iterations in
    SPLIT_ITERATIONS, with the interest mask as given and thinned to every
    8th point (n_constraints recomputed), fitted by least squares as
    t = launch + iterations x (fixed + per_point x points), where
    iterations is the largest count of evaluated iterations over the pairs
    and points the mean interest points per pair (all frames). Returns
    (launch us, fixed us per iteration, per-point ns per iteration)."""
    import dataclasses

    import torch

    from vslam_tpu_torch.alignment import fused_solve

    data, rel0, img, cam, cfg, xp = args
    every8 = torch.zeros_like(data.mask)
    every8[..., ::8] = True
    thin = data.mask & every8
    masks = {"all": data, "every 8th": data._replace(mask=thin, n_constraints=thin.sum(-1).float())}
    rows, groups = [], []
    for name, d in masks.items():
        points = float(d.mask.sum(dim=(1, 2)).float().mean())
        for n_it in SPLIT_ITERATIONS:
            c = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, max_iterations=n_it))
            run = (lambda d, c: lambda: fused_solve.solve_level_fused(d, rel0, img, cam, c, xp))(d, c)
            rows.append([name, n_it, int(_evaluated(run()[1].chi2_history)), points])
            groups.append((run, 20, "solve_level_kernel"))
    for row, ms in zip(rows, _device_ms_batch(groups)):
        row.append(ms)
    X = np.array([[1.0, e, e * p] for _, _, e, p, _ in rows])
    y = np.array([r[-1] for r in rows]) * 1e3
    (launch, fixed, per_point), *_ = np.linalg.lstsq(X, y, rcond=None)
    B_, F_, P_ = data.mask.shape
    log(f"split {label} (B={B_}, F={F_}, P={P_}): " + "; ".join(
        f"{n} max_it {i}: {e} it, {p:.0f} pts, {ms * 1e3:.2f} us" for n, i, e, p, ms in rows) + f" {card}")
    log(f"split {label}: fit t = {launch:.2f} us + iterations x ({fixed:.3f} us + {per_point * 1e3:.3f} ns "
        f"x points) {card}")
    return launch, fixed, per_point * 1e3


def _samplers_vs_plain(problems, frames, kernels, log):
    """Phase 9: each per-iteration kernel against its plain version on the
    64 pairs' finest level, bit for bit. Sample and NE at F=1 (the
    reference frame at the half-way pose) and F=2 (reference and half-way
    frame) in {nearest, bilinear} x {f32, bf16}; mxu at the F=2 warped
    points and at 4096 points per pair on and outside the image border.
    Returns the largest |kernel - plain| by kernel."""
    import torch

    from vslam_tpu_torch.alignment import ic
    from vslam_tpu_torch.core.se3 import SE3

    data2, rel2, _ = problems["f2"]
    rel1 = SE3(rel2.R[:, :1].contiguous(), rel2.t[:, :1].contiguous())
    cur = frames["cur"]
    img, cam = cur.intensity[0], cur.cameras[0]
    err = dict.fromkeys(kernels, 0.0)
    for F, (data, rel) in ((1, (problems["f1"][0], rel1)), (2, (data2, rel2))):
        for dtype in (torch.float32, torch.bfloat16):
            for interp in ("nearest", "bilinear"):
                args = (data, rel, img.to(dtype), cam, interp)
                errs = []
                for name in ("fused_level_sample", "fused_level_ne"):
                    k = kernels[name]
                    errs.append(_max_abs_diff(k.wrapper(*args), k.plain(*args)))
                    err[name] = max(err[name], errs[-1])
                log(f"phase 9 F={F} {interp} {str(dtype)[6:]}: fused_level_sample max_abs_err "
                    f"{errs[0]:.3e}, fused_level_ne {errs[1]:.3e} (P={data.mask.shape[-1]})")
    u, v, vis = ic._warp_visibility(data2, rel2, img.shape[-2:], cam)
    rng = np.random.default_rng(9)
    edges_u = [-2.0, -1.0, -0.5, 0.0, 0.5, W - 1.5, W - 1.0, W - 0.5, W, W + 1.0]
    edges_v = [-2.0, -1.0, -0.5, 0.0, 0.5, H - 1.5, H - 1.0, H - 0.5, H, H + 1.0]
    n = 1024
    bu = np.concatenate([rng.choice(edges_u, (B, n)), rng.uniform(-2, W + 1, (B, n)),
                         rng.uniform(-W, 2 * W, (B, 2 * n))], 1)
    bv = np.concatenate([rng.uniform(-2, H + 1, (B, n)), rng.choice(edges_v, (B, n)),
                         rng.uniform(-H, 2 * H, (B, 2 * n))], 1)
    k = kernels["bilinear_sample_mxu"]
    points = {"warped": (u.reshape(B, -1), v.reshape(B, -1)),
              "border": tuple(torch.as_tensor(x, dtype=torch.float32, device=img.device) for x in (bu, bv))}
    for what, (pu, pv) in points.items():
        got = k.wrapper(img, pu, pv)
        e = _max_abs_diff(got, k.plain(img, pu, pv))
        err["bilinear_sample_mxu"] = max(err["bilinear_sample_mxu"], e)
        log(f"phase 9 bilinear_sample_mxu at {pu.shape[1]} {what} points per pair: max_abs_err {e:.3e}, "
            f"zero samples {(got == 0).float().mean().item():.3f}")
    log(f"phase 9: visible share at F=2 {vis.float().mean().item():.3f}")
    if any(e != 0.0 for e in err.values()):
        raise AssertionError(f"phase 9: kernel and plain differ: {err}")
    return err


def _counted_run(label, call, kernel, xis, log):
    """Phase 10, one run: ``call()`` (a main-path entry point, returning
    (rel (B,), valid (B,))) with every launch count at 0, recording each
    level's solver history and the last arguments each level gave the
    kernel's wrapper. Gates: the kernel launched once per evaluation of the
    batched loop (per level the largest count of finite chi2 history
    entries over the pairs, summed over the levels), no whole-level launch,
    every pair valid, mean error < 0.01. Returns (launches, {image width:
    args})."""
    import torch

    from vslam_tpu_torch.alignment import fused_solve, ic

    hist, by_level = [], {}
    _reset_launches()
    with _tap(ic, "solve_level", lambda a, out: hist.append(out[1].chi2_history)), \
            _tap(kernel.module, kernel.wrapper.__name__,
                 lambda a, out: by_level.__setitem__(a[kernel.image_arg].shape[-1], a)):
        rel, valid = call()
        _sync()
    launches = getattr(kernel.module, kernel.counter)
    evaluations = sum(int(torch.isfinite(h).sum(dim=1).max()) for h in hist)
    errs = _pair_errors(rel, xis)
    log(f"phase 10 {label}: {kernel.wrapper.__name__} launches {launches}, batched-loop evaluations "
        f"{evaluations} over {len(hist)} levels, whole-level launches {fused_solve.LAUNCHES}; valid "
        f"{int(valid.sum())}/{B}; mean per-pair SE(3) error {errs.mean():.5f} (gate 0.01), max {errs.max():.5f}")
    if not (launches == evaluations > 0 and len(hist) == N_LEVELS and fused_solve.LAUNCHES == 0):
        raise AssertionError(f"phase 10 {label}: launches {launches}, evaluations {evaluations}, "
                             f"whole-level {fused_solve.LAUNCHES}")
    if not (bool(valid.all()) and errs.mean() < 0.01):
        raise AssertionError(f"phase 10 {label}: an invalid pair or mean error {errs.mean()} >= 0.01")
    return launches, by_level


def _per_iteration_paths(frames, xis, kernels, log):
    """Phase 10: the per-iteration samplers through the entry points at full
    width, then each kernel against its plain version at the inputs each
    level gave it. Returns ({kernel: launches}, {kernel: {width: args}},
    {kernel: max_abs_err}, {sampler: align_pairs config})."""
    import dataclasses

    import torch

    from vslam_tpu_torch.core import se3
    from vslam_tpu_torch.core.se3 import SE3
    from vslam_tpu_torch.kalman import ekf_se3
    from vslam_tpu_torch.parallel.batched import align_pairs, tracking_step
    from vslam_tpu_torch.solvers import LossConfig

    device = frames["cur"].intensity[0].device
    ref, cur = frames["ref"], frames["cur"]
    prod = _production_cfg()
    rel0 = SE3(torch.eye(3, device=device).expand(B, 3, 3).contiguous(), torch.zeros(B, 3, device=device))
    x_pred = torch.zeros(B, 6, device=device)
    ekf0 = ekf_se3.init(pose=se3.identity((B,), device=device))
    dts = torch.full((B,), 1.0 / 30.0, device=device)
    cfgs = {"fused": dataclasses.replace(prod, sampler="fused"),
            "mxu": dataclasses.replace(prod, sampler="mxu", interpolation="bilinear", image_dtype="float32")}
    huber = dataclasses.replace(prod, sampler="fused", loss=LossConfig("Huber"))

    def pairs(cfg):
        rel, _, valid = align_pairs(ref, cur, rel0, x_pred, cfg)
        return rel, valid

    def tracking():
        _, rel, valid = tracking_step(ekf0, ref, cur, dts, huber)
        return rel, valid

    runs = {"fused_level_ne": ("align_pairs, production profile, sampler fused", lambda: pairs(cfgs["fused"])),
            "fused_level_sample": ("tracking_step, Huber, sampler fused", tracking),
            "bilinear_sample_mxu": ("align_pairs, sampler mxu, bilinear, f32", lambda: pairs(cfgs["mxu"]))}
    launches, captured, err = {}, {}, {}
    for name, (label, call) in runs.items():
        launches[name], captured[name] = _counted_run(label, call, kernels[name], xis, log)
    for name, by_level in captured.items():
        k = kernels[name]
        err[name] = 0.0
        for width, args in sorted(by_level.items(), reverse=True):
            e = _max_abs_diff(k.wrapper(*args), k.plain(*args))
            err[name] = max(err[name], e)
            log(f"phase 10 {name} at the last inputs of the {width}-wide level: max_abs_err {e:.3e}")
    if any(e != 0.0 for e in err.values()):
        raise AssertionError(f"phase 10: kernel and plain differ at the main path's inputs: {err}")
    return launches, captured, err, cfgs


# keyframe, last and current frame of the odometry profile for phase 11;
# the prediction is the last frame's pose, so the solve absorbs the motion
# of three frames
VLOG_FRAMES = (0, 3, 6)
VLOG_SINKS = ("ImageWarped", "Residual", "Weights")


def _pose_gap(a: np.ndarray, b: np.ndarray) -> float:
    from vslam_tpu_torch.core import lie_np

    return float(np.linalg.norm(lie_np.log(lie_np.relative(a, b))))


def _visual_log(poses, stream, camera, log):
    """Phase 11: RgbdAligner.align at 480x640, F=2, with every visual-log
    sink on and then off; gates in the module doc. Returns (sample
    launches, robust whole-level launches with the sinks off, align(sinks_on)
    for the timings)."""
    import dataclasses

    import torch

    from vslam_tpu_torch.alignment import RgbdAligner, fused_ne, fused_solve
    from vslam_tpu_torch.core.frame import create_frame
    from vslam_tpu_torch.solvers import LossConfig
    from vslam_tpu_torch.utils import log as vlog

    device = camera.fx.device

    def frame(k):
        _, gray, depth = stream[k]
        return create_frame(torch.as_tensor(gray, device=device).float(),
                            torch.as_tensor(depth.astype(np.float32), device=device) * (1.0 / 5000.0),
                            camera, n_levels=N_LEVELS)

    kf, last, cur = VLOG_FRAMES
    cfg = dataclasses.replace(_odometry_cfg("odometry").alignment, loss=LossConfig("Huber"))
    aligner = RgbdAligner(cfg)
    args = ([frame(kf), frame(last)], [poses[kf], poses[last]], frame(cur), poses[last])
    got = {n: [] for n in VLOG_SINKS + ("SolverGN",)}
    sinks = [vlog.log_img(n) for n in VLOG_SINKS] + [vlog.log_plt("SolverGN")]

    def align(sinks_on: bool):
        for s in sinks:
            s.enabled = sinks_on
            s.callback = (lambda name, x: got[name].append(x)) if sinks_on else None
        try:
            return aligner.align(*args)
        finally:
            for s in sinks:
                s.enabled, s.callback = False, None

    _reset_launches()
    pose_rec, _, ok = align(True)
    _sync()
    samples, whole = fused_ne.SAMPLE_LAUNCHES, fused_solve.LAUNCHES
    _frame_builds("11")
    (payload,) = got["SolverGN"]
    n_eval = np.isfinite(payload["chi2"]).sum(axis=1)  # per level, coarsest first
    want = [(2, H >> lvl, W >> lvl) for i, lvl in enumerate(range(N_LEVELS - 1, -1, -1))
            for _ in range(n_eval[i])]
    shapes_ok = all([a.shape for a in got[n]] == want for n in VLOG_SINKS)

    def mean_abs(a):
        nz = np.abs(a)
        return nz[nz > 0].mean()

    coarse = got["Residual"][: n_eval[0]]
    fall = 1.0 - mean_abs(coarse[-1]) / mean_abs(coarse[0])
    err_rec = _pose_gap(pose_rec, poses[cur])
    _reset_launches()
    pose_off, _, ok_off = align(False)
    _sync()
    off = (fused_solve.LAUNCHES, fused_solve.ROBUST_LAUNCHES)
    gap = _pose_gap(pose_rec, pose_off)
    log(f"phase 11 RgbdAligner F=2 {H}x{W} frames {VLOG_FRAMES}, Huber, bilinear bf16, fused_gn, sinks on: "
        f"evaluated iterations per level (coarsest first) {n_eval.tolist()}, images per sink "
        f"{[len(got[n]) for n in VLOG_SINKS]} shaped as one per evaluation {shapes_ok}; "
        f"fused_level_sample launches {samples}, whole-level launches {whole}; coarsest mean |r| "
        f"{mean_abs(coarse[0]):.4f} -> {mean_abs(coarse[-1]):.4f} (fall {fall:.3f}, gate 0.10); pose "
        f"error {err_rec:.5f} (gate 0.01), valid {ok}. Sinks off: whole-level launches (all, robust) "
        f"{off}, pose {gap:.2e} from the recorded one (gate 2e-2), valid {ok_off}")
    if not (ok and ok_off and shapes_ok and samples == int(n_eval.sum()) and whole == 0):
        raise AssertionError("phase 11: images, launches or validity off with the sinks on")
    if not (fall >= 0.10 and err_rec < 0.01 and off == (N_LEVELS, N_LEVELS) and gap < 2e-2):
        raise AssertionError("phase 11: residual fall, pose error, sinks-off launches or pose gap off")
    return samples, off[1], align


def _time_samplers(kernels, captured, card, log):
    """Phase 12, kernels: at phase 10's inputs of each level, each new
    kernel's device ms (profiler, 20 launches) beside the launch floor (a
    one-element zero_(), the smallest PyTorch kernel, 20 launches in the
    same window), its plain version's (events, best of two runs of 3 calls
    around the kernel's) and the bound of its work; grid_sample beside the
    mxu kernel (device ms by the profiler). Returns {kernel: entry fields of
    the kernels line}."""
    import torch

    out = {}
    for name, k in kernels.items():
        ms = plain = lib = ops = nbytes = 0.0
        for width, args in sorted(captured[name].items(), reverse=True):
            o, b = k.work(args, k.wrapper(*args))
            ops, nbytes = ops + o, nbytes + b
            run_k = lambda: k.wrapper(*args)  # noqa: E731
            run_p = lambda: k.plain(*args)  # noqa: E731
            run_p()
            p1 = _events_ms(run_p, 3)
            one = torch.zeros(1, device=args[k.image_arg].device)
            k_ms, floor_ms = _device_ms_batch([(run_k, 20, k.cuda_name), (one.zero_, 20, None)])
            p2 = _events_ms(run_p, 3)
            ms, plain = ms + k_ms, plain + min(p1, p2)
            extra = ""
            if name == "bilinear_sample_mxu":
                img, u, v = args
                Hl, Wl = img.shape[-2:]
                grid = torch.stack([u / (Wl - 1) * 2 - 1, v / (Hl - 1) * 2 - 1], dim=-1)[:, None]
                run_lib = lambda: torch.nn.functional.grid_sample(  # noqa: E731
                    img[:, None], grid, mode="bilinear", padding_mode="zeros", align_corners=True)
                l_ms, names = _calls_device_ms(run_lib, 20)
                lib += l_ms
                gap = (run_lib()[:, 0, 0] - run_k()).abs().max().item()
                extra = (f", grid_sample {l_ms:.4f} ms on the device (kernels {names}; max |difference| "
                         f"from the kernel {gap:.2e})")
            bound_l, by_l = _bound(o, b)
            log(f"phase 12 {name} at the {args[k.image_arg].shape[-2]}x{width} level "
                f"({tuple(args[k.image_arg].shape)} image): kernel {k_ms:.4f} ms on the device (profiler, "
                f"20 launches), launch floor {floor_ms * 1e3:.3f} us (a one-element zero_() in the same "
                f"window; not a bound), plain {min(p1, p2):.3f} ms (events, runs {p1:.3f}, {p2:.3f}){extra}; "
                f"bound {bound_l * 1e3:.3f} us ({by_l}: {o:.3e} operations, {b:.3e} bytes) {card}")
        bound_ms, by = _bound(ops, nbytes)
        out[name] = {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": by,
                     "library_ms": lib if name == "bilinear_sample_mxu" else None}
    return out


def _time_paths(frames, cfgs, align_vlog, card, log):
    """Phase 12, paths: align_pairs ms per call (events, best of two runs of
    3 calls after a warm-up) with each sampler, and RgbdAligner.align ms
    (host clock, best of 2) with the sinks on and off."""
    import dataclasses

    import torch

    from vslam_tpu_torch.core.se3 import SE3
    from vslam_tpu_torch.parallel.batched import align_pairs

    device = frames["cur"].intensity[0].device
    rel0 = SE3(torch.eye(3, device=device).expand(B, 3, 3).contiguous(), torch.zeros(B, 3, device=device))
    x_pred = torch.zeros(B, 6, device=device)
    # fused_gn also with the mxu run's sampling (bilinear, f32 image)
    samplers = dict(cfgs, fused_gn=_production_cfg())
    samplers["fused_gn bilinear f32"] = dataclasses.replace(samplers["mxu"], sampler="fused_gn")
    for name, cfg in samplers.items():
        call = lambda: align_pairs(frames["ref"], frames["cur"], rel0, x_pred, cfg)  # noqa: E731
        call()
        runs = [_events_ms(call, 3) for _ in range(2)]
        log(f"phase 12 align_pairs sampler {name}: {min(runs):.3f} ms per call of {B} pairs (runs "
            f"{', '.join(f'{r:.3f}' for r in runs)}) {card}")
    for on in (True, False):
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            align_vlog(on)
            times.append((time.perf_counter() - t0) * 1e3)
        log(f"phase 12 RgbdAligner.align F=2 {H}x{W}, sinks {'on' if on else 'off'}: {min(times):.3f} ms "
            f"(host clock, runs {', '.join(f'{t:.3f}' for t in times)}) {card}")


CTAS_TRIED = (1, 2, 4, 8)
NE_CTAS_TRIED = (1, 2, 4, 8)
NE_IN_FLIGHT_TRIED = (1, 2, 4)
SAMPLE_PTS_TRIED = (1, 2, 4)
# phase 16's builds of fused_ne.cu, the design constants each sets, per
# kernel: the NE kernel's CTA counts at every frame size (kNeClusterPoints
# 0), the package's own build ({}), its points in flight; the sampler's
# points per thread
RESIDUAL_SWEEPS = {
    "fused_level_ne": [{"kNeCtas": c, "kNeClusterPoints": 0} for c in NE_CTAS_TRIED] + [{}]
                      + [{"kNeInFlight": f} for f in NE_IN_FLIGHT_TRIED],
    "fused_level_sample": [{"kSamplePts": p} for p in SAMPLE_PTS_TRIED],
}
MXU_ROUNDS = 5
# phase 15's split of the mxu kernel: the source built at each kMxuStage
MXU_STAGES = {0: "empty grid", 1: "coordinates alone", 2: "full kernel"}


def _source_constant(source: str, name: str) -> int:
    from vslam_tpu_torch import _build

    return int(re.search(rf"constexpr int {name} = (\d+);", (_build.SRC_DIR / source).read_text())[1])


def _variant_key(stem: str, constants: dict):
    return stem, tuple(sorted(constants.items()))


def _start_variants():
    """Start the nvcc of the variants the sweeps measure (one process each,
    all together): the whole-level kernel at each CTA count of CTAS_TRIED,
    each build of RESIDUAL_SWEEPS, the mxu kernel at each of MXU_STAGES and
    the frame build at each of FB_SWEEP, but those whose constants are all
    the source's own. Returns
    (`_build.Variants`, their keys)."""
    from vslam_tpu_torch import _build

    specs = [("fused_solve", {"kCtas": c}) for c in CTAS_TRIED]
    specs += [("fused_ne", v) for variants in RESIDUAL_SWEEPS.values() for v in variants]
    specs += [("sample_mxu", {"kMxuStage": stage}) for stage in MXU_STAGES]
    specs += [("frame_build", v) for v in FB_SWEEP]
    keys, todo = [], []
    for stem, constants in specs:
        key = _variant_key(stem, constants)
        if key not in keys and any(_source_constant(f"{stem}.cu", k) != x for k, x in constants.items()):
            keys.append(key)
            todo.append((stem, constants))
    return _build.Variants(todo), keys


def _max_clusters(args, lib=None) -> str:
    """'n of B': the most clusters of the whole-level launch at ``args``
    that the card holds at once, beside the B pairs it launches."""
    import ctypes

    from vslam_tpu_torch import _build

    data, _, image, _, cfg, _ = args
    B, F, P = data.mask.shape
    if not image.is_cuda:
        return f"? of {B}"
    n = ctypes.c_int(0)
    err = (_build.library() if lib is None else lib).vslam_solve_level_clusters(
        B, F, P, int(cfg.loss.function != "None"), int(cfg.image_dtype == "bfloat16"),
        int(cfg.interpolation == "bilinear"), ctypes.byref(n))
    return f"{n.value if err == 0 else f'error {err}'} of {B}"


def _solve_result_diff(got, want) -> float:
    (rel_k, res_k), (rel_p, res_p) = got, want
    fields = lambda rel, res: (rel.R, rel.t, res.A, res.b, res.chi2, res.iterations.float(),  # noqa: E731
                               res.chi2_history, res.step_history)
    return _max_abs_diff(fields(rel_k, res_k), fields(rel_p, res_p))


def _solve_sweep(inputs, libs, card, log):
    """The whole-level kernel built with each CTA count of CTAS_TRIED (the
    package's own build where it is the source's), at every level's
    main-path inputs of each path of ``inputs`` ({label:
    per-level arguments}: `align_pairs` at B = 64, the odometry and the
    robust profile at B = 1): each held bit for bit against the plain
    version summing in its CTA count's order, then timed (device ms,
    profiler, 20 launches) beside its evaluated iterations (the most over
    the pairs), which the sum order can move. Returns {(CTA count, label):
    ms over the 3 levels}."""
    from vslam_tpu_torch.alignment import fused_solve

    times = {}
    for c in CTAS_TRIED:
        lib = libs.get(_variant_key("fused_solve", {"kCtas": c}))
        name = f"kCtas={c}"
        groups, evals = [], []
        for label in inputs:
            for args in inputs[label]:
                run = (lambda args: lambda: fused_solve._from_out(args[1], *fused_solve._launch(*args, lib=lib)))(args)
                got = run()
                err = _solve_result_diff(got, fused_solve.solve_level_fused_plain(*args, ctas=c))
                if err != 0.0:
                    raise AssertionError(f"{name} {label}: kernel and plain (ctas={c}) differ by {err}")
                evals.append(int(_evaluated(got[1].chi2_history)))
                groups.append((run, 20, "solve_level_kernel"))
        ms = _device_ms_batch(groups)
        for i, label in enumerate(inputs):
            levels = list(zip(ms[3 * i:3 * i + 3], evals[3 * i:3 * i + 3], inputs[label]))
            total = sum(m for m, _, _ in levels)
            times[(c, label)] = total
            log(f"sweep {label} {name}: {total:.4f} ms over 3 levels (" + " / ".join(
                f"{m:.4f} ms {e} it, {_max_clusters(a, lib)} clusters at once" for m, e, a in levels)
                + f"), bit-equal with the plain version at ctas={c} {card}")
    for label in inputs:
        log(f"sweep {label}: " + ", ".join(f"kCtas={c} {times[(c, label)]:.4f} ms" for c in CTAS_TRIED)
            + f"; the source's kCtas = {_source_constant('fused_solve.cu', 'kCtas')} {card}")
    return times


def _residual_sweep(captured, libs, card, log):
    """Phase 16: each build of RESIDUAL_SWEEPS (the package's own where its
    constants are the source's) at phase 10's inputs of every level
    (``captured``, {kernel: {width: args}}): each held bit for bit against
    its plain version (the NE's summing over the build's CTA count, or by
    `ne_ctas`), then timed (device ms, profiler, 20 launches) in two runs in
    turns (the builds in order, then reversed) in one window per kernel;
    the best of the two, and the fastest build at each level."""
    from vslam_tpu_torch.alignment import fused_ne

    kernels = _new_kernels()
    out = {}
    for kernel, variants in RESIDUAL_SWEEPS.items():
        ne = kernel == "fused_level_ne"
        launch = fused_ne._launch_ne if ne else fused_ne._launch_sample
        levels = [args for _, args in sorted(captured[kernel].items(), reverse=True)]
        runs = {}
        for vi, v in enumerate(variants):
            lib = libs.get(_variant_key("fused_ne", v))
            for li, args in enumerate(levels):
                runs[vi, li] = (lambda a, lib: lambda: launch(*a, lib=lib))(args, lib)
                want = (fused_ne.fused_level_ne_plain(*args, ctas=v.get("kNeCtas")) if ne
                        else fused_ne.fused_level_sample_plain(*args))
                err = _max_abs_diff(runs[vi, li](), want)
                if err != 0.0:
                    raise AssertionError(f"phase 16 {kernel} {v} level {li}: kernel and plain differ by {err}")
        idx = list(range(len(variants)))
        order = [(vi, li) for vi in idx + idx[::-1] for li in range(len(levels))]
        ms = _device_ms_batch([(runs[key], 20, kernels[kernel].cuda_name) for key in order])
        names = [" ".join(f"{k}={x}" for k, x in v.items()) or "the package's build" for v in variants]
        for vi, name in enumerate(names):
            pairs = [[m for key, m in zip(order, ms) if key == (vi, li)] for li in range(len(levels))]
            out[kernel, vi] = [min(p) for p in pairs]
            log(f"phase 16 {kernel} {name}: " + " / ".join(
                f"{min(p) * 1e3:.3f} us (runs {p[0] * 1e3:.3f}, {p[1] * 1e3:.3f})" for p in pairs)
                + f" at the {' / '.join(str(a[2].shape[-1]) + '-wide' for a in levels)} levels, "
                f"{sum(out[kernel, vi]):.5f} ms over {len(levels)}; bit-equal with the plain version {card}")
        best = [names[min(idx, key=lambda vi: out[kernel, vi][li])] for li in range(len(levels))]
        consts = sorted({k for v in variants for k in v})
        log(f"phase 16 {kernel}: fastest per level (finest first) {best}; the source's "
            + ", ".join(f"{k} = {_source_constant('fused_ne.cu', k)}" for k in consts) + f" {card}")


def _evaluated(history):
    """Evaluated iterations of a launch: the most finite history entries
    over its pairs."""
    import torch

    return torch.isfinite(history).sum(dim=1).max()


def _mxu_alternated(by_width, card, log):
    """Kernel 4 against grid_sample (bilinear, zeros, align_corners) at each
    level of the `align_pairs` mxu run, in alternation: MXU_ROUNDS rounds of
    kernel, grid_sample, grid_sample, kernel, 20 calls each, in one
    profiler window. Returns {width: (kernel mean ms, grid_sample mean ms,
    kernel spread, grid_sample spread)}, spread = max - min over the
    rounds."""
    import torch

    from vslam_tpu_torch.alignment import pallas_kernels as pk

    out = {}
    for width, args in sorted(by_width.items(), reverse=True):
        img, u, v = args
        Hl, Wl = img.shape[-2:]
        grid = torch.stack([u / (Wl - 1) * 2 - 1, v / (Hl - 1) * 2 - 1], dim=-1)[:, None]
        run_lib = lambda: torch.nn.functional.grid_sample(  # noqa: E731
            img[:, None], grid, mode="bilinear", padding_mode="zeros", align_corners=True)
        run_k = lambda: pk.bilinear_sample_mxu(*args)  # noqa: E731
        order = [run_k, run_lib, run_lib, run_k] * MXU_ROUNDS
        ms = _device_ms_batch([(fn, 20, None if fn is run_lib else "sample_mxu_kernel") for fn in order])
        ks = [m for fn, m in zip(order, ms) if fn is run_k]
        gs = [m for fn, m in zip(order, ms) if fn is run_lib]
        km, gm = float(np.mean(ks)), float(np.mean(gs))
        kspread, gspread = max(ks) - min(ks), max(gs) - min(gs)
        verdict = ("at or below" if km <= gm else
                   "within the spread of" if km - gm <= max(kspread, gspread) else "slower than")
        out[width] = (km, gm, kspread, gspread)
        log(f"mxu alternated {Hl}x{Wl} level ({u.shape[1]} points per pair, B={u.shape[0]}): kernel "
            f"{km * 1e3:.3f} us (spread {kspread * 1e3:.3f}), grid_sample {gm * 1e3:.3f} us (spread "
            f"{gspread * 1e3:.3f}), {MXU_ROUNDS} rounds kernel,grid_sample,grid_sample,kernel: the kernel "
            f"is {verdict} grid_sample {card}")
    return out


def _mxu_split(by_width, builds, label, card, log):
    """Where the mxu kernel's time goes at each level of the `align_pairs`
    mxu run (``by_width``, {width: args}): device ms (profiler, 20
    launches, best of two runs in turns) of the builds of one design at
    each of MXU_STAGES, and of any further measurement builds (``builds``,
    {name: C entries}, MXU_STAGES' names first; None for the package's),
    beside the launch floor (a one-element zero_() in the same window) and
    the bound. Returns {width: {name: ms}}."""
    import torch

    from vslam_tpu_torch.alignment import pallas_kernels as pk

    out = {}
    for width, args in sorted(by_width.items(), reverse=True):
        img, u, _ = args
        one = torch.zeros(1, device=img.device)
        runs = [(lambda lib: lambda: pk._launch(*args, lib=lib))(lib) for lib in builds.values()]
        runs.append(one.zero_)
        order = list(range(len(runs))) + list(range(len(runs)))[::-1]
        ms = _device_ms_batch([(runs[i], 20, "sample_mxu_kernel" if i < len(builds) else None) for i in order])
        best = [min(m for i, m in zip(order, ms) if i == k) for k in range(len(runs))]
        out[width] = dict(zip(builds, best))
        t = out[width]
        empty, coords, full = (t[name] for name in MXU_STAGES.values())
        bound_ms, by = _bound(*_mxu_work(args, None))
        log(f"mxu split {label}, {img.shape[-2]}x{width} level ({u.shape[1]} points per pair, B={u.shape[0]}): "
            + ", ".join(f"{name} {m * 1e3:.3f} us" for name, m in t.items())
            + f" (best of 2 in turns); launch floor {best[-1] * 1e3:.3f} us; the coordinates "
            f"{(coords - empty) * 1e3:.3f} us above the grid, the sampling {(full - coords) * 1e3:.3f} us above "
            f"the coordinates; bound {bound_ms * 1e3:.3f} us ({by}) {card}")
    return out


# phase 17: frames of the pipeline's short runs in other configurations, of
# the default (gather) configuration's run, and of the profiled window
PIPE_SHORT_FRAMES = 8
PIPE_GATHER_FRAMES = 16
PIPE_MAPPING_FRAMES = 16
PIPE_PROFILED_FRAMES = 16
# phase 18: frames of each synthetic CLI run
CLI_FRAMES = 16
# phase 19: GN iterations of the dense robust solves, and the sampler's rows
DENSE_ITERATIONS = 10
SAMPLE_ROWS = 70_000


def _host_waits(fn):
    """(fn()'s result, the host's waits for the card inside it): every
    synchronizing CUDA call, as torch's sync debug mode reports them."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing" in str(w.message) for w in caught)


def _pipeline_run(cfg, stream, pipelined, device):
    """One `OdometryPipeline` run over ``stream`` with every launch count
    at 0, each level solve's evaluated iterations recorded and the host's
    waits for the card counted. Returns (trajectory, the keyframes' stamps,
    wall s, evaluated iterations, host waits)."""
    import torch

    from vslam_tpu_torch.alignment import ic
    from vslam_tpu_torch.core.camera import Camera
    from vslam_tpu_torch.odometry.pipeline import OdometryPipeline

    pipe = OdometryPipeline(Camera(FX, FX, (W - 1) / 2, (H - 1) / 2), cfg, device=device)
    keyframes = []
    insert = pipe.map.insert

    def record(frame, is_keyframe=False):
        if is_keyframe:
            keyframes.append(frame.t_ns)
        insert(frame, is_keyframe)

    pipe.map.insert = record
    hist = []
    _reset_launches()
    _sync()
    with _tap(ic, "solve_level", lambda a, out: hist.append(out[1].chi2_history)):
        t0 = time.perf_counter()
        traj, waits = _host_waits(lambda: pipe.run(iter(stream), pipelined=pipelined))
        _sync()
        wall = time.perf_counter() - t0
    evaluations = sum(int(torch.isfinite(h).sum()) for h in hist)
    _frame_builds("17")
    return traj, keyframes, wall, evaluations, waits


def _trajectory_ate(poses, traj):
    return _ate(poses, [(t, T, None) for t, T in traj.items()])


def _pipeline_profiled(cfg, stream, pipelined, device):
    """(host ms, CUDA launch calls, device-busy ms) per frame of one
    pipeline run under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vslam_tpu_torch.core.camera import Camera
    from vslam_tpu_torch.odometry.pipeline import OdometryPipeline

    pipe = OdometryPipeline(Camera(FX, FX, (W - 1) / 2, (H - 1) / 2), cfg, device=device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.run(iter(stream), pipelined=pipelined)
        _sync()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    calls = sum(1 for e in events if e.device_type == DeviceType.CPU
                and e.name.startswith(("cudaLaunch", "cuLaunch")))
    _, busy = _device_busy(events)
    n = len(stream)
    return wall / n, calls / n, busy / n


def _pipeline(poses, stream, device, card, log):
    """Phase 17: `OdometryPipeline` at 480x640 over the odometry profile's
    frames in the sensor dtypes, production profile (`fused_gn`, bf16,
    2048 points), software-pipelined and strict; kernel 1 against its plain
    version at one frame's level-0 inputs; 8 frames each of Huber,
    `fused` (quadratic, then Huber), `mxu`, and 16 frames of the default
    `gather` configuration. Returns {kernel name: launches}."""
    import dataclasses

    from vslam_tpu_torch.alignment import fused_ne, fused_solve, pallas_kernels
    from vslam_tpu_torch.config import PipelineConfig
    from vslam_tpu_torch.core import lie_np

    n = len(stream)
    levels = N_LEVELS * (n - 1)
    cfg = PipelineConfig(sampler="fused_gn", image_dtype="bfloat16", features_max_points=2048)
    runs, walls, captured, counts = {}, {"pipelined": [], "strict": []}, {}, {"solve_level_fused": 0}
    sink = lambda a, _: captured.__setitem__("level0", a) if a[2].shape[-1] == W else None  # noqa: E731
    # in turns, so that the two schedules share the host's state
    for label in ("pipelined", "strict", "strict", "pipelined"):
        with _tap(fused_solve, "solve_level_fused", sink):
            traj, kfs, wall, _, waits = _pipeline_run(cfg, stream, label == "pipelined", device)
        launches = _launches()
        counts["solve_level_fused"] += launches[0]
        ate = _trajectory_ate(poses, traj)
        walls[label].append(wall)
        log(f"phase 17 pipeline {label}: {n} frames at {H}x{W}, fused_gn bf16 2048 points; whole-level "
            f"launches (quadratic, robust) {launches} (expected ({levels}, 0)); keyframes {len(kfs)}; ATE "
            f"{ate:.5f} m (gate 0.01); {n / wall:.2f} frames/s ({wall:.3f} s); host waits {waits} = "
            f"{waits / n:.3f} per frame (torch's sync debug mode) {card}")
        if launches != (levels, 0) or not ate < 0.01:
            raise AssertionError(f"phase 17 {label}: launches {launches} or ATE {ate} off")
        runs.setdefault(label, (traj, kfs, waits))
    for label, ws in walls.items():
        log(f"phase 17 pipeline {label}: {n / min(ws):.2f} frames/s, best of {', '.join(f'{w:.3f}' for w in ws)} s "
            f"(runs in turns pipelined, strict, strict, pipelined) {card}")
    (tp, kp, waits_p), (ts, ks, waits_s) = runs["pipelined"], runs["strict"]
    # the strict loop fetches every aligned frame's pose; the pipelined one
    # a batch of 4 at a time (and seeds its device chain once)
    if waits_s < n - 1 or waits_p > waits_s / 2:
        raise AssertionError(f"phase 17: host waits {waits_p} pipelined, {waits_s} strict over {n} frames")
    gaps = [np.linalg.norm(lie_np.log(lie_np.relative(tp.pose_at(t), T))) for t, T in ts.items()]
    log(f"phase 17 strict against pipelined: per-frame pose gap max {max(gaps):.3e} (gate 2e-3), the "
        f"same keyframes {kp == ks}")
    if not (kp == ks and max(gaps) < 2e-3 and len(ts) == len(tp) == n):
        raise AssertionError("phase 17: the two schedules disagree")

    args = captured["level0"]
    out_k = fused_solve.solve_level_fused(*args)
    out_p = fused_solve.solve_level_fused_plain(*args)
    err = _solve_result_diff(out_k, out_p)
    log(f"phase 17 kernel 1 at the last run's last level-0 inputs (F={args[0].templ.shape[1]}, "
        f"P={args[0].templ.shape[-1]}): max abs difference from the plain version {err:.3e} over the "
        f"pose, A, b, chi2, iterations and histories")
    if err != 0.0:
        raise AssertionError(f"phase 17: kernel 1 and its plain version differ by {err}")

    for label, pipelined in (("pipelined", True), ("strict", False)):
        host_ms, calls, busy = _pipeline_profiled(cfg, stream[:PIPE_PROFILED_FRAMES], pipelined, device)
        log(f"phase 17 pipeline {label} under torch.profiler ({PIPE_PROFILED_FRAMES} frames): host "
            f"{host_ms:.3f} ms, {calls:.1f} launch calls, device busy {busy:.3f} ms per frame "
            f"({busy / host_ms:.3f} of the wall) {card}")

    short = stream[:PIPE_SHORT_FRAMES]
    others = {
        "solve_level_fused_robust": ("Huber, fused_gn", dataclasses.replace(cfg, loss_function="Huber"),
                                     lambda: fused_solve.ROBUST_LAUNCHES),
        "fused_level_ne": ("fused, quadratic", dataclasses.replace(cfg, sampler="fused"),
                           lambda: fused_ne.NE_LAUNCHES),
        "fused_level_sample": ("fused, Huber", dataclasses.replace(cfg, sampler="fused", loss_function="Huber"),
                               lambda: fused_ne.SAMPLE_LAUNCHES),
        "bilinear_sample_mxu": ("mxu, f32", dataclasses.replace(cfg, sampler="mxu", image_dtype="float32"),
                                lambda: pallas_kernels.MXU_LAUNCHES),
    }
    for name, (label, cfg_k, counter) in others.items():
        traj, _, wall, evaluations, _ = _pipeline_run(cfg_k, short, True, device)
        all_counts = (fused_solve.LAUNCHES, fused_ne.SAMPLE_LAUNCHES, fused_ne.NE_LAUNCHES,
                      pallas_kernels.MXU_LAUNCHES)
        counts[name] = counter()
        ate = _trajectory_ate(poses[:len(short)], traj)
        want = N_LEVELS * (len(short) - 1) if name == "solve_level_fused_robust" else evaluations
        log(f"phase 17 pipeline {label}: {len(short)} frames, {name} launches {counts[name]} (expected "
            f"{want}; evaluated iterations {evaluations}); launches (whole-level, sample, NE, mxu) "
            f"{all_counts}; ATE {ate:.5f} m (gate 0.01); {len(short) / wall:.2f} frames/s {card}")
        if counts[name] != want or sum(all_counts) != counts[name] or not ate < 0.01:
            raise AssertionError(f"phase 17 {label}: launches {all_counts} or ATE {ate} off")

    gather = stream[:PIPE_GATHER_FRAMES]
    traj, _, wall, _, _ = _pipeline_run(PipelineConfig(), gather, True, device)
    all_counts = (fused_solve.LAUNCHES, fused_ne.SAMPLE_LAUNCHES, fused_ne.NE_LAUNCHES, pallas_kernels.MXU_LAUNCHES)
    ate = _trajectory_ate(poses[:len(gather)], traj)
    log(f"phase 17 pipeline, default configuration (gather, dense 32768 points, f32): {len(gather)} frames, "
        f"kernel launches {all_counts} (expected none); ATE {ate:.5f} m (gate 0.01); "
        f"{len(gather) / wall:.2f} frames/s {card}")
    if any(all_counts) or not ate < 0.01:
        raise AssertionError(f"phase 17 gather: launches {all_counts} or ATE {ate} off")

    mapped = stream[:PIPE_MAPPING_FRAMES]
    for option in ("enable_mapping", "enable_loop_closure"):
        with _mapping_warnings(f"phase 17 {option}"):
            traj, kfs, wall, _, _ = _pipeline_run(dataclasses.replace(cfg, **{option: True}), mapped, None, device)
        launches = _launches()
        counts["solve_level_fused"] += launches[0]
        ate = _trajectory_ate(poses[:len(mapped)], traj)
        log(f"phase 17 pipeline with {option}: {len(mapped)} frames (the strict loop), keyframes {len(kfs)}, "
            f"whole-level launches {launches} (expected ({N_LEVELS * (len(mapped) - 1)}, 0)); ATE {ate:.5f} m "
            f"(gate 0.01); {len(mapped) / wall:.2f} frames/s {card}")
        if launches != (N_LEVELS * (len(mapped) - 1), 0) or not ate < 0.01:
            raise AssertionError(f"phase 17 {option}: launches {launches} or ATE {ate} off")
    return counts, tp


def _cli_json(argv):
    """(exit code, printed lines) of one `evaluate.main` call."""
    import io

    from vslam_tpu_torch.eval import evaluate

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = evaluate.main(argv)
    return rc, buf.getvalue().splitlines()


def _cli(poses, traj, stream, card, log):
    """Phase 18: the CLI's `synthetic` at 480x640, host loop and --fused
    (ATE < 0.01 m); `evaluate`, `ate` and `rpe` on phase 17's pipelined
    trajectory and its ground truth (exit 0); `odometry` on a TUM directory
    where PIL is importable to write its PNGs."""
    import os
    import tempfile

    from vslam_tpu_torch.core import lie_np
    from vslam_tpu_torch.io import tum

    for flags in ([], ["--fused"], ["--mapping"], ["--fused", "--mapping"]):
        t0 = time.perf_counter()
        with _mapping_warnings(f"phase 18 synthetic {flags}"):
            rc, lines = _cli_json(["synthetic", "--frames", str(CLI_FRAMES), "--height", str(H), "--width", str(W),
                                   "--fx", str(FX), *flags])
        (res,) = [json.loads(line) for line in lines if line.startswith("{")]
        log(f"phase 18 CLI synthetic {' '.join(flags) or '(host loop)'}: exit {rc}, {res} "
            f"({time.perf_counter() - t0:.1f} s with the rendering) {card}")
        if rc != 0 or not res["ate_rmse_m"] < 0.01 or res["frames"] != CLI_FRAMES:
            raise AssertionError(f"phase 18 synthetic {flags}: exit {rc}, {res}")
        if "--mapping" in flags and not res["landmarks"] > 0:
            raise AssertionError(f"phase 18 synthetic {flags}: no landmarks")
    with tempfile.TemporaryDirectory() as d:
        gt, est = os.path.join(d, "groundtruth.txt"), os.path.join(d, "trajectory.txt")
        tum.write_trajectory(gt, {i * DT_NS / 1e9: lie_np.inv(p) for i, p in enumerate(poses)})
        tum.write_trajectory(est, {t / 1e9: lie_np.inv(T) for t, T in traj.items()})
        for argv in (["evaluate", "--fixed-delta", "0.2"], ["ate", "--verbose"],
                     ["rpe", "--fixed-delta", "--delta", "0.2", "--verbose"]):
            rc, lines = _cli_json([argv[0], "--gt", gt, "--algo", est, *argv[1:]])
            log(f"phase 18 CLI {' '.join(argv)}: exit {rc}: {' | '.join(lines)}")
            if rc != 0:
                raise AssertionError(f"phase 18 {argv[0]}: exit {rc}")
        if not _png_reader():
            log("phase 18 CLI odometry on a TUM directory: not run, no PNG reader here (the native decoder "
                "did not build and PIL is not importable)")
            return
        root = os.path.join(d, "tum")
        _write_tum(root, poses, stream[:PIPE_SHORT_FRAMES])
        rc, lines = _cli_json(["odometry", "--dataset", root, "--out", os.path.join(d, "tum.txt"),
                               "--intrinsics", f"{FX},{FX},{(W - 1) / 2},{(H - 1) / 2}", "--fused",
                               "--chunk", "4"])
        log(f"phase 18 CLI odometry --fused on a TUM directory of {PIPE_SHORT_FRAMES} PNG frames: exit {rc}, "
            f"{' | '.join(lines)}")
        if rc != 0:
            raise AssertionError(f"phase 18 odometry: exit {rc}")


# phase 20: the KITTI stereo scan, `bench.py:1064-1110` unchanged
KITTI_H, KITTI_W = 376, 1241
KITTI_CAM = (718.856, 718.856, 607.1928, 185.2157)
KITTI_BASELINE = 0.5372
KITTI_FRAMES = 32
KITTI_CHUNK = 16
KITTI_LEVELS = 4
KITTI_DT_NS = int(1e9 / 10)
KITTI_ATE_GATE = 0.25  # bench.py:1122
KITTI_JAX_ATE_M = 0.0035  # the JAX package's accuracy record, BENCH_r05.json "kitti_ate_m"
# phase 21: the suite, `bench.py:689-736` unchanged
SUITE_S = 4
SUITE_FRAMES = 32
SUITE_CHUNK = 16
SUITE_RAGGED = 24  # sequence 3's length in the ragged run
RENDER_THREADS = 8


def _walls(fn, reps=2):
    """Host-clock seconds of ``reps`` calls of ``fn``, each ending in a
    synchronize."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync()
        out.append(time.perf_counter() - t0)
    return out


def _render_all(jobs):
    """The host renders (numpy, mostly outside the GIL) on RENDER_THREADS
    threads, results in order."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(RENDER_THREADS) as pool:
        return list(pool.map(lambda job: job(), jobs))


def _u8(img):
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def _kitti_stream():
    """(poses, [(t_ns, left u8, right u8)]) of the bench's KITTI geometry:
    the slanted street plane, `smooth_trajectory(32, 0.4, 0.01)` re-based on
    frame 0, the right camera 0.5372 m along the left one's +x."""
    from vslam_tpu_torch.core import lie_np
    from vslam_tpu_torch.io import synthetic

    K = synthetic.camera_matrix(*KITTI_CAM)
    scene = synthetic.PlaneScene(normal=(0.0, -0.25, 1.0), d=12.0, n_waves=12)
    poses = synthetic.smooth_trajectory(KITTI_FRAMES, trans_amp=0.4, rot_amp=0.01)
    p0i = lie_np.inv(poses[0])
    poses = [p @ p0i for p in poses]
    right = np.eye(4)
    right[0, 3] = -KITTI_BASELINE
    imgs = _render_all([lambda T=off @ p: _u8(synthetic.render(K, T, (KITTI_H, KITTI_W), scene)[0])
                        for p in poses for off in (np.eye(4), right)])
    return poses, [(i * KITTI_DT_NS, imgs[2 * i], imgs[2 * i + 1]) for i in range(len(poses))]


def _kitti_cfg():
    """`bench.py:1093-1110`: the production alignment profile with
    `min_gradient` 20 and bilinear sampling, 4 levels, stereo depth."""
    import dataclasses

    from vslam_tpu_torch.odometry.sequential import SequentialConfig

    align = dataclasses.replace(_production_cfg(), min_gradient=20.0, interpolation="bilinear")
    return SequentialConfig(alignment=align, n_levels=KITTI_LEVELS, kf_period=5,
                            stereo_baseline=KITTI_BASELINE, stereo_max_disparity=96)


def _kitti_ate(poses, results):
    from vslam_tpu_torch.core import lie_np
    from vslam_tpu_torch.eval import metrics

    gt = {i * KITTI_DT_NS / 1e9: lie_np.inv(p) for i, p in enumerate(poses)}
    est = {t / 1e9: lie_np.inv(p) for t, p, _ in results}
    ate, n = metrics.ate_rmse(gt, est, max_difference=0.05)
    if n != len(poses):
        raise AssertionError(f"ATE associated {n} of {len(poses)} frames")
    return float(ate)


def _kitti(poses, stream, card, log):
    """Phase 20: `SequentialOdometry` over the KITTI stream (stereo depth by
    block matching inside each step): the block matcher on the card against
    the same function on the CPU at the first pair, the counted run (4 x 31
    whole-level launches, ATE < 0.25 m), frames/s staged and streamed,
    kernel 1 against its plain version at each level's inputs (odd sizes)
    with its device ms, and under torch.profiler the block matcher's device
    ms, launch calls and share of a step, and the peak memory. Returns
    (launches, kernel 1's largest difference from its plain version)."""
    import torch
    from torch.autograd import DeviceType

    from vslam_tpu_torch.alignment import fused_solve
    from vslam_tpu_torch.core.camera import Camera
    from vslam_tpu_torch.io import kitti
    from vslam_tpu_torch.odometry.sequential import SequentialOdometry, stage_stream

    cfg = _kitti_cfg()
    camera = Camera.create(*KITTI_CAM)
    n_steps = len(stream) - 1
    D = cfg.stereo_max_disparity

    left, right = (torch.from_numpy(a).float() for a in stream[0][1:])
    disp_card = kitti.block_matching_disparity(left.cuda(), right.cuda(), D).cpu()
    disp_host = kitti.block_matching_disparity(left, right, D)
    n_diff = int((disp_card != disp_host).sum())
    share_card, share_host = ((d > 0).float().mean().item() for d in (disp_card, disp_host))
    err_disp = (disp_card - disp_host).abs().max().item()
    log(f"phase 20 block matcher (D={D}) at the first pair, card against CPU: valid share {share_card:.4f} "
        f"and {share_host:.4f}, validity equal {torch.equal(disp_card > 0, disp_host > 0)}, {n_diff} of "
        f"{disp_card.numel()} pixels differ, max |d disparity| {err_disp:.3e} px (limit 1e-4)")
    if not (torch.equal(disp_card > 0, disp_host > 0) and err_disp < 1e-4 and share_card > 0.3):
        raise AssertionError("phase 20: the block matcher on the card disagrees with the CPU")

    odo = SequentialOdometry(camera, cfg, chunk=KITTI_CHUNK)
    _reset_launches()
    results = odo.run(iter(stream))
    _sync()
    launches = _launches()
    _frame_builds("20")
    ate = _kitti_ate(poses, results)
    log(f"phase 20 KITTI stereo scan: {len(results)} frames at {KITTI_W}x{KITTI_H}, {KITTI_LEVELS} levels, chunk "
        f"{KITTI_CHUNK}; launches (quadratic, robust) {launches} (expected ({KITTI_LEVELS * n_steps}, 0)); valid "
        f"{sum(odo.valid)}/{len(results)}, keyframes {sum(odo.is_kf)}; ATE {ate:.5f} m (gate {KITTI_ATE_GATE}; the "
        f"JAX package's accuracy record {KITTI_JAX_ATE_M} m)")
    if launches != (KITTI_LEVELS * n_steps, 0) or not ate < KITTI_ATE_GATE:
        raise AssertionError(f"phase 20: launches {launches} or ATE {ate} off")

    first, chunks = stage_stream(iter(stream), KITTI_CHUNK)
    odo.run_staged(first, chunks)
    staged = _walls(lambda: odo.run_staged(first, chunks))
    streamed = _walls(lambda: SequentialOdometry(camera, cfg, chunk=KITTI_CHUNK).run(iter(stream)))
    n = len(stream)
    log(f"phase 20 KITTI: run_staged {n / min(staged):.2f} frames/s (best of "
        f"{', '.join(f'{t:.3f}' for t in staged)} s for {n} frames), run {n / min(streamed):.2f} frames/s "
        f"(best of {', '.join(f'{t:.3f}' for t in streamed)} s) {card}")

    captured = _profile_solve_inputs(odo, first, chunks)
    widths = [args[2].shape[-1] for args in captured]
    if len(captured) != KITTI_LEVELS:
        raise AssertionError(f"phase 20: captured level widths {widths}, expected {KITTI_LEVELS} levels")
    max_err = 0.0
    for level, args in enumerate(captured):
        out_k = fused_solve.solve_level_fused(*args)
        err = _solve_result_diff(out_k, fused_solve.solve_level_fused_plain(*args))
        max_err = max(max_err, err)
        ms_k, seen = _kernel_device_ms(lambda: fused_solve.solve_level_fused(*args), 20, "solve_level_kernel")
        ms_p = _events_ms(lambda: fused_solve.solve_level_fused_plain(*args), 2)
        log(f"phase 20 kernel 1 at level {level} ({args[2].shape[-2]}x{args[2].shape[-1]}, F={args[0].templ.shape[1]}, "
            f"P={args[0].templ.shape[-1]}, iterations {out_k[1].iterations.tolist()}): max abs difference from the "
            f"plain version {err:.3e} over the pose, A, b, chi2, iterations and histories; kernel "
            f"{ms_k:.4f} ms on the device (profiler, {seen} of 20 recorded), plain {ms_p:.3f} ms (events) {card}")
    if max_err != 0.0:
        raise AssertionError(f"phase 20: kernel 1 and its plain version differ by {max_err} at KITTI's levels")

    # the block matcher alone, at the step's (1, H, W) inputs
    l_d, r_d = left.cuda()[None], right.cuda()[None]
    bm = lambda: kitti.stereo_depth(l_d, r_d, camera.fx, KITTI_BASELINE, max_disparity=D)  # noqa: E731
    bm_ms, _ = _calls_device_ms(bm, 5)
    calls = sum(1 for e in _profiled_events(bm) if e.device_type == DeviceType.CPU
                and e.name.startswith(("cudaLaunch", "cuLaunch")))
    _sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bm()
    _sync()
    bm_peak = torch.cuda.max_memory_allocated() - base
    k = len(chunks[0].stamps)
    split, _, n_kernels, busy_ms, wall = _frame_layers(odo, first, chunks[0], k,
                                                       extra=[(kitti, "stereo_depth", "block matcher")])
    torch.cuda.reset_peak_memory_stats()
    odo.run_staged(first, chunks[:1])
    _sync()
    peak = torch.cuda.max_memory_allocated()
    n1 = k + 1
    busy_frame = busy_ms / n1
    step_ms, step_calls = split["step"]
    bm_host, bm_calls = split["block matcher"]
    volume = D * KITTI_H * KITTI_W * 4
    log(f"phase 20 block matcher per frame: {bm_ms:.3f} ms on the device (profiler, all its kernels, mean of 5 "
        f"calls), {calls} launch calls (in the step: {bm_calls:.1f} of {step_calls:.1f}), host "
        f"{bm_host:.3f} of the step's {step_ms:.3f} ms under torch.profiler ({bm_host / step_ms:.3f}); "
        f"{bm_ms / busy_frame if busy_frame else float('nan'):.3f} of the step's device-busy {busy_frame:.3f} ms "
        f"({n_kernels / n1:.1f} "
        f"kernels a frame, wall {wall / n1:.3f} ms a frame); peak memory above the inputs "
        f"{bm_peak / 2**20:.1f} MiB for one call ({bm_peak / volume:.2f} cost volumes of "
        f"{volume / 2**20:.1f} MiB), {peak / 2**20:.1f} MiB allocated at most over a {KITTI_CHUNK}-frame chunk "
        f"{card}")
    parts = ", ".join(f"{name} {ms:.3f} ms / {c:.1f} launch calls" for name, (ms, c) in split.items())
    log(f"phase 20 KITTI layers per step under torch.profiler (mean of {k} steps): {parts} {card}")
    return launches[0], max_err


def _suite_poses():
    """`smooth_trajectory(32, 0.08, 0.03)` re-based on frame 0."""
    from vslam_tpu_torch.core import lie_np
    from vslam_tpu_torch.io import synthetic

    poses = synthetic.smooth_trajectory(SUITE_FRAMES, trans_amp=0.08, rot_amp=0.03)
    p0i = lie_np.inv(poses[0])
    return [p @ p0i for p in poses]


def _suite_sequence(s, poses):
    """Sequence s of the suite: `default_scene(seed=100+s)` along ``poses``,
    uint8 / uint16 at 1/5000 m."""
    from vslam_tpu_torch.io import synthetic

    K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    frames = _render_all([lambda p=p: synthetic.render(K, p, (H, W), synthetic.default_scene(seed=100 + s))
                          for p in poses])
    return [(i * DT_NS, _u8(inten), np.clip(np.round(depth * 5000.0), 0, 65535).astype(np.uint16))
            for i, (inten, depth) in enumerate(frames)]


def _suite_streams():
    """(poses, S streams) of `bench.py:689-713`."""
    poses = _suite_poses()
    return poses, [_suite_sequence(s, poses) for s in range(SUITE_S)]


def _suite(poses, streams, card, log):
    """Phase 21: `MultiSequenceOdometry` over the S = 4 streams (the
    odometry profile): the counted `run` (3 x 31 whole-level launches for
    all four, max ATE < 0.01 m), `run_staged` (the same gate), each
    sequence within 1e-3 of its own `SequentialOdometry` run, every slot
    of a suite of four copies of sequence 0 bit-equal to sequence 0 of the
    suite, kernel 1 at
    the suite's level-0 inputs (B = 4) against its plain version, aggregate
    frames/s staged and streamed beside 4 x the single sequence's, and the
    ragged run (sequence 3 cut to 24 frames). Returns (launches, kernel 1's
    difference from its plain version, the counted `run`'s trajectories)."""
    from vslam_tpu_torch.alignment import fused_solve
    from vslam_tpu_torch.core import lie_np
    from vslam_tpu_torch.core.camera import Camera
    from vslam_tpu_torch.odometry.sequential import SequentialOdometry, stage_stream
    from vslam_tpu_torch.parallel.sequences import MultiSequenceOdometry

    cfg = _odometry_cfg("odometry")
    camera = Camera.create(FX, FX, (W - 1) / 2, (H - 1) / 2)
    n_steps = SUITE_FRAMES - 1

    def counted(seqs, label):
        odo = MultiSequenceOdometry([camera] * len(seqs), cfg, chunk=SUITE_CHUNK)
        _reset_launches()
        res = odo.run([iter(s) for s in seqs])
        _sync()
        launches = _launches()
        _frame_builds("21")
        ates = [_ate(poses[:len(s)], r) for s, r in zip(seqs, res)]
        log(f"phase 21 suite {label}: S={len(seqs)} x {'/'.join(str(len(s)) for s in seqs)} frames at {H}x{W}, "
            f"chunk {SUITE_CHUNK}; launches (quadratic, robust) {launches} (expected ({3 * n_steps}, 0)); ATE "
            f"{', '.join(f'{a:.5f}' for a in ates)} m (gate 0.01)")
        if launches != (3 * n_steps, 0) or not max(ates) < 0.01 or [len(r) for r in res] != [len(s) for s in seqs]:
            raise AssertionError(f"phase 21 {label}: launches {launches}, ATE {ates} or lengths off")
        return res, launches[0]

    res, launches = counted(streams, "run")
    gaps = []
    for s, stream in enumerate(streams):
        solo = SequentialOdometry(camera, cfg, chunk=SUITE_CHUNK).run(iter(stream))
        gaps.append(max(np.linalg.norm(lie_np.log(lie_np.relative(a[1], b[1]))) for a, b in zip(solo, res[s])))
    log(f"phase 21 each sequence against its own SequentialOdometry run: per-frame SE(3) gap max "
        f"{', '.join(f'{g:.3e}' for g in gaps)} (gate 1e-3)")
    if not max(gaps) < 1e-3:
        raise AssertionError(f"phase 21: suite and single-sequence runs differ by {max(gaps)}")
    # the gap above starts in cuBLAS's batched 3x3 products (se3.compose),
    # whose last bits differ between a batch of 1 and of 4
    # (scripts/suite_parity.py); within one batch size a slot's result
    # depends on its own stream only
    copies = MultiSequenceOdometry([camera] * SUITE_S, cfg, chunk=SUITE_CHUNK).run(
        [iter(streams[0]) for _ in range(SUITE_S)])
    same = [all(np.array_equal(a[1], b[1]) for a, b in zip(c, res[0])) for c in copies]
    log(f"phase 21 a suite of {SUITE_S} copies of sequence 0: each slot's poses bit-equal to sequence 0's in the "
        f"suite of the {SUITE_S} sequences: {same}")
    if not all(same):
        raise AssertionError(f"phase 21: a slot's poses depend on the other slots' streams: {same}")

    odo = MultiSequenceOdometry([camera] * SUITE_S, cfg, chunk=SUITE_CHUNK)
    firsts, chunks = odo.stage_streams([iter(s) for s in streams])
    staged_res = odo.run_staged(firsts, chunks)
    _sync()
    ates = [_ate(poses, r) for r in staged_res]
    staged = _walls(lambda: odo.run_staged(firsts, chunks))
    streamed = _walls(lambda: MultiSequenceOdometry([camera] * SUITE_S, cfg, chunk=SUITE_CHUNK).run(
        [iter(s) for s in streams]))
    single = SequentialOdometry(camera, cfg, chunk=SUITE_CHUNK)
    first1, chunks1 = stage_stream(iter(streams[0]), SUITE_CHUNK)
    single.run_staged(first1, chunks1)
    single_staged = _walls(lambda: single.run_staged(first1, chunks1))
    single_streamed = _walls(lambda: SequentialOdometry(camera, cfg, chunk=SUITE_CHUNK).run(iter(streams[0])))
    total = SUITE_S * SUITE_FRAMES
    agg, agg_s = total / min(staged), total / min(streamed)
    one, one_s = SUITE_FRAMES / min(single_staged), SUITE_FRAMES / min(single_streamed)
    log(f"phase 21 suite run_staged: max ATE {max(ates):.5f} m (gate 0.01); aggregate {agg:.2f} frames/s staged "
        f"(best of {', '.join(f'{t:.3f}' for t in staged)} s for {total} frames) against {SUITE_S} x the single "
        f"sequence's {one:.2f} = {SUITE_S * one:.2f} ({agg / one:.2f} x single); streamed {agg_s:.2f} (best of "
        f"{', '.join(f'{t:.3f}' for t in streamed)} s) against {SUITE_S} x {one_s:.2f} = {SUITE_S * one_s:.2f} "
        f"({agg_s / one_s:.2f} x single) {card}")
    if not max(ates) < 0.01:
        raise AssertionError(f"phase 21 run_staged: ATE {ates}")

    captured = {}
    with _tap(fused_solve, "solve_level_fused", lambda args, _: captured.__setitem__(args[2].shape[-1], args)):
        odo.run_staged(firsts, chunks[:1])
    _sync()
    args = captured[W]
    out_k = fused_solve.solve_level_fused(*args)
    err = _solve_result_diff(out_k, fused_solve.solve_level_fused_plain(*args))
    ms_k, seen = _kernel_device_ms(lambda: fused_solve.solve_level_fused(*args), 20, "solve_level_kernel")
    log(f"phase 21 kernel 1 at the suite's level-0 inputs (B={args[0].templ.shape[0]}, F={args[0].templ.shape[1]}, "
        f"P={args[0].templ.shape[-1]}, camera leaves {tuple(args[3].fx.shape)}): max abs difference from the plain "
        f"version {err:.3e}; kernel {ms_k:.4f} ms on the device (profiler, {seen} of 20 recorded) {card}")
    if err != 0.0 or args[0].templ.shape[0] != SUITE_S:
        raise AssertionError(f"phase 21: kernel 1 at B={args[0].templ.shape[0]} differs by {err}")

    ragged = streams[:-1] + [streams[-1][:SUITE_RAGGED]]
    res_r, launches_r = counted(ragged, f"ragged (sequence {SUITE_S - 1} cut to {SUITE_RAGGED} frames)")
    gap_r = max(np.linalg.norm(lie_np.log(lie_np.relative(a[1], b[1]))) for a, b in zip(res_r[-1], res[-1]))
    log(f"phase 21 ragged: sequence {SUITE_S - 1}'s {SUITE_RAGGED} frames against the same frames of the full "
        f"run: per-frame gap max {gap_r:.3e} (gate 1e-3)")
    if not gap_r < 1e-3:
        raise AssertionError(f"phase 21 ragged: gap {gap_r}")
    return launches + launches_r, err, res


def _write_png(path, img):
    """An 8- or 16-bit gray PNG (filter None, one zlib stream), written
    without PIL."""
    import struct
    import zlib

    img = np.ascontiguousarray(img)
    h, w = img.shape
    bits = 16 if img.dtype == np.uint16 else 8
    raw = img.astype(">u2" if bits == 16 else np.uint8)
    rows = b"".join(b"\x00" + raw[r].tobytes() for r in range(h))

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def _png_reader() -> bool:
    """Whether the port can read PNG files here: its native decoder builds
    (g++ and zlib), or PIL is importable."""
    import importlib.util

    from vslam_tpu_torch.io import tum

    return tum._use_native() or importlib.util.find_spec("PIL") is not None


def _write_tum(root, poses, stream):
    """A TUM directory of ``stream``'s (t_ns, uint8, uint16) frames, PNG,
    with ``poses`` as its ground truth."""
    import os

    from vslam_tpu_torch.core import lie_np
    from vslam_tpu_torch.io import tum

    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "depth"))
    rgb, depth = [], []
    for i, (_, gray, d16) in enumerate(stream):
        t = 1000.0 + i / 30.0
        _write_png(os.path.join(root, "rgb", f"{t:.6f}.png"), gray)
        _write_png(os.path.join(root, "depth", f"{t:.6f}.png"), d16)
        rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
        depth.append(f"{t:.6f} depth/{t:.6f}.png")
    for name, rows in (("rgb.txt", rgb), ("depth.txt", depth)):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(rows) + "\n")
    tum.write_trajectory(os.path.join(root, "groundtruth.txt"),
                         {1000.0 + i / 30.0: lie_np.inv(p) for i, p in enumerate(poses[:len(stream)])})


def _write_kitti(root, poses, stream):
    """A KITTI odometry root (sequence 00) of ``stream``'s stereo pairs, PNG,
    with the bench's calibration, times and ground truth."""
    import os

    from vslam_tpu_torch.core import lie_np

    seq = os.path.join(root, "sequences", "00")
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(seq, sub))
    os.makedirs(os.path.join(root, "poses"))
    for i, (_, left, right) in enumerate(stream):
        _write_png(os.path.join(seq, "image_0", f"{i:06d}.png"), left)
        _write_png(os.path.join(seq, "image_1", f"{i:06d}.png"), right)
    fx, fy, cx, cy = KITTI_CAM
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        f.write(f"P0: {fx} 0 {cx} 0 0 {fy} {cy} 0 0 0 1 0\n"
                f"P1: {fx} 0 {cx} {-fx * KITTI_BASELINE} 0 {fy} {cy} 0 0 0 1 0\n")
    with open(os.path.join(seq, "times.txt"), "w") as f:
        f.write("\n".join(f"{i * KITTI_DT_NS / 1e9:.6f}" for i in range(len(stream))) + "\n")
    with open(os.path.join(root, "poses", "00.txt"), "w") as f:
        f.write("\n".join(" ".join(f"{v:.9f}" for v in lie_np.inv(p)[:3, :4].reshape(-1)) for p in poses) + "\n")


def _cli_kitti_suites(tum_sets, kitti_poses, kitti_stream, card, log):
    """Phase 18, its KITTI and suite half: `odometry --format kitti` on a
    KITTI root of PIPE_SHORT_FRAMES bench pairs (host loop and --fused), a
    repeated --dataset on two TUM directories (the odometry and robust
    profiles' first frames) and on two KITTI roots (the KITTI stream's
    first and second PIPE_SHORT_FRAMES pairs), each exit 0 with the ATE
    printed; then the fused KITTI run and the TUM suite with --mapping.
    Needs a PNG reader (the output says where there is none). Returns the
    whole-level launches."""
    import os
    import tempfile

    if not _png_reader():
        log("phase 18 CLI on KITTI roots and suites: not run, no PNG reader here (the native decoder did not "
            "build and PIL is not importable)")
        return 0
    n = PIPE_SHORT_FRAMES
    launches = 0
    with tempfile.TemporaryDirectory() as d:
        tums = [os.path.join(d, f"tum{k}") for k in range(2)]
        for root, (poses, stream) in zip(tums, tum_sets):
            _write_tum(root, poses, stream[:n])
        kittis = [os.path.join(d, f"kitti{k}") for k in range(2)]
        for k, root in enumerate(kittis):
            _write_kitti(root, kitti_poses[k * n:(k + 1) * n], kitti_stream[k * n:(k + 1) * n])
        tum_k = f"{FX},{FX},{(W - 1) / 2},{(H - 1) / 2}"
        runs = [("odometry --format kitti (host loop)", ["--dataset", kittis[0], "--format", "kitti"]),
                ("odometry --format kitti --fused", ["--dataset", kittis[0], "--format", "kitti", "--fused"]),
                ("odometry suite of two TUM directories",
                 ["--dataset", tums[0], "--dataset", tums[1], "--intrinsics", tum_k, "--fused"]),
                ("odometry suite of two KITTI roots",
                 ["--dataset", kittis[0], "--dataset", kittis[1], "--format", "kitti", "--fused"]),
                ("odometry --format kitti --fused --mapping",
                 ["--dataset", kittis[0], "--format", "kitti", "--fused", "--mapping"]),
                ("odometry suite of two TUM directories --mapping",
                 ["--dataset", tums[0], "--dataset", tums[1], "--intrinsics", tum_k, "--fused", "--mapping"])]
        for label, argv in runs:
            _reset_launches()
            t0 = time.perf_counter()
            with _mapping_warnings(f"phase 18 {label}"):
                rc, lines = _cli_json(["odometry", *argv, "--out", os.path.join(d, "out.txt"), "--chunk", "4"])
            _sync()
            launches += _launches()[0]
            res = [json.loads(line) for line in lines if line.startswith("{")]
            entries = res[-1].get("results", [res[-1]]) if res else []
            ates = [e.get("ate_rmse_m") for e in entries]
            log(f"phase 18 CLI {label}: exit {rc}, {len(res)} JSON lines, ATE {ates} m, whole-level launches "
                f"{_launches()[0]} ({time.perf_counter() - t0:.1f} s) {card}")
            if rc != 0 or not ates or not all(isinstance(a, float) and np.isfinite(a) for a in ates):
                raise AssertionError(f"phase 18 {label}: exit {rc}, {lines[-3:]}")
    return launches


def _render_composite(K, pose, shape):
    """`tests/test_icp.py`'s three tilted planes (the nearer surface wins):
    three independent normals, which point-to-plane ICP needs to fix every
    translation."""
    from vslam_tpu_torch.io import synthetic

    i, d = None, None
    for s in (synthetic.PlaneScene(normal=(0.35, 0.0, 1.0), d=2.0, seed=1),
              synthetic.PlaneScene(normal=(-0.3, 0.25, 1.0), d=1.6, seed=2),
              synthetic.PlaneScene(normal=(0.1, -0.4, 1.0), d=1.8, seed=3)):
        ii, dd = synthetic.render(K, pose, shape, s)
        if d is None:
            i, d = ii, dd
        else:
            take = (dd > 0) & ((dd < d) | (d <= 0))
            d, i = np.where(take, dd, d), np.where(take, ii, i)
    return i.astype(np.float32), d.astype(np.float32)


def _secondary_aligners(poses, stream, card, log):
    """Phase 22: the secondary aligners on the card at 480x640, each with
    its JAX test's gate and its time (CUDA events around the call, best of
    3 after a warm-up): `RgbdAlignerFa` on frames 0 and 2 of the odometry
    profile (pose error < 0.01); `IcpAligner` on two frames of the JAX
    test's three-plane scene (< 0.012; the profile's single plane leaves
    two translations free); `align_optical_flow` and `align_affine` (both
    methods) on the JAX tests' smooth image (cubic zoom of noise at a
    quarter of the size; the profile's texture repeats every few pixels,
    too fine for the forward-additive gradients) warped by their shift and
    affine map (flow within 0.1 px; the affine matrix within 0.05, and
    every image corner within 0.1 px of where the map puts it)."""
    import torch
    from scipy.ndimage import affine_transform, shift as nd_shift

    from vslam_tpu_torch.alignment import fa_se3, icp, lk2d
    from vslam_tpu_torch.core import lie_np
    from vslam_tpu_torch.core.camera import Camera
    from vslam_tpu_torch.core.frame import create_frame
    from vslam_tpu_torch.io import synthetic
    from vslam_tpu_torch.solvers import SolverConfig

    camera = Camera.create(FX, FX, (W - 1) / 2, (H - 1) / 2)
    device = camera.fx.device

    def frame(inten, depth):
        return create_frame(torch.as_tensor(inten, dtype=torch.float32, device=device),
                            torch.as_tensor(depth, dtype=torch.float32, device=device), camera, n_levels=N_LEVELS)

    def timed(fn):
        fn()
        return fn(), min(_events_ms(fn, 1) for _ in range(3))

    gap = lambda a, b: float(np.linalg.norm(lie_np.log(lie_np.relative(a, b))))  # noqa: E731
    failures = []

    (_, i0, d0), (_, i2, d2) = stream[0], stream[2]
    f0, f2 = frame(i0, d0 / 5000.0), frame(i2, d2 / 5000.0)
    fa = fa_se3.RgbdAlignerFa(fa_se3.FaAlignmentConfig(min_gradient=10.0))
    (pose, _, ok), ms = timed(lambda: fa.align([f0], [poses[0]], f2, poses[0]))
    err = gap(pose, poses[2])
    log(f"phase 22 RgbdAlignerFa, frames 0 and 2 of the odometry profile at {H}x{W}: ok {ok}, pose error "
        f"{err:.5f} (gate 0.01), {ms:.3f} ms a call {card}")
    failures += [] if ok and err < 0.01 else ["RgbdAlignerFa"]

    K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    xi = np.array([0.015, 0.01, -0.01, 0.005, 0.006, -0.004])
    g0, g1 = (frame(*_render_composite(K, T, (H, W))) for T in (np.eye(4), lie_np.exp(xi)))
    for variant, gate in (("point_to_plane", 0.012), ("point_to_point", 0.03)):
        aligner = icp.IcpAligner(icp.IcpConfig(solver=SolverConfig(max_iterations=30, min_step_size=1e-7),
                                               variant=variant))
        (pose, _, ok), ms = timed(lambda: aligner.align([g0], [np.eye(4)], g1, np.eye(4)))
        err = gap(pose, lie_np.exp(xi))
        log(f"phase 22 IcpAligner {variant}, the three-plane scene at {H}x{W}: ok {ok}, pose error {err:.5f} "
            f"(gate {gate}), {ms:.3f} ms a call {card}")
        failures += [] if ok and err < gate else [f"IcpAligner {variant}"]

    from scipy.ndimage import zoom

    img = zoom(np.random.default_rng(42).uniform(0, 255, (H // 4, W // 4)), 4, order=3).astype(np.float32)
    flow = np.array([2.3, -1.7])
    shifted = nd_shift(img, shift=(flow[1], flow[0]), order=1, mode="nearest")
    # the JAX test's map; the image is I = T o W^-1 with the map in (row, col) order
    A = np.array([[1.02, -0.015, 1.5], [0.01, 1.025, -2.0]])
    Ainv = np.linalg.inv(np.vstack([A, [0, 0, 1]]))
    warped = affine_transform(img, Ainv[:2, :2][::-1, ::-1], offset=(Ainv[1, 2], Ainv[0, 2]), order=1,
                              mode="nearest")
    corners = np.array([[0, W - 1, 0, W - 1], [0, 0, H - 1, H - 1], [1, 1, 1, 1]], np.float64)
    t_img, t_shift, t_warp = (torch.as_tensor(a, device=device) for a in (img, shifted, warped))
    for method in ("inverse_compositional", "forward_additive"):
        cfg = lk2d.Lk2dConfig(method=method)
        (p, res), ms = timed(lambda: lk2d.align_optical_flow(t_img, t_shift, cfg=cfg))
        err = float(np.abs(p.cpu().numpy() - flow).max())
        log(f"phase 22 align_optical_flow {method}, the smooth image at {H}x{W}: valid {bool(res.valid)}, flow {p.tolist()}, max "
            f"error {err:.4f} px (gate 0.1), {int(res.iterations)} iterations, {ms:.3f} ms a call {card}")
        failures += [] if bool(res.valid) and err < 0.1 else [f"align_optical_flow {method}"]
        (p, res), ms = timed(lambda: lk2d.align_affine(t_img, t_warp, cfg=cfg))
        q = p.cpu().numpy().astype(np.float64)
        miss = np.array([[1 + q[0], q[2], q[4]], [q[1], 1 + q[3], q[5]]]) - A
        err, px = float(np.abs(miss).max()), float(np.linalg.norm(miss @ corners, axis=0).max())
        log(f"phase 22 align_affine {method}, the smooth image at {H}x{W}: valid {bool(res.valid)}, matrix max error {err:.5f} "
            f"(gate 0.05), corner error {px:.5f} px (gate 0.1), {int(res.iterations)} iterations, {ms:.3f} ms a call {card}")
        failures += [] if bool(res.valid) and err < 0.05 and px < 0.1 else [f"align_affine {method}"]
    if failures:
        raise AssertionError(f"phase 22: {failures} missed their gates")


def _smem_path(F, P, robust=True):
    """Where the whole-level kernel keeps the robust residual cache at
    (F, P): "shared" or "global scratch"."""
    import ctypes

    from vslam_tpu_torch import _build

    need, limit = ctypes.c_int(0), ctypes.c_int(0)
    if _build.library().vslam_solve_level_smem(F, P, int(robust), ctypes.byref(need), ctypes.byref(limit)):
        raise AssertionError("the shared-memory query failed")
    return ("shared" if need.value <= limit.value else "global scratch"), need.value, limit.value


def _size_repairs(frames, xis, log):
    """Phase 19: the robust entry on the pairs' dense level 0 (F = 2) with
    its residual cache in global memory, and the per-iteration sampler
    above the grid's 65,535 rows; each bit for bit against its plain
    version. Returns {kernel name: max_abs_err}."""
    import dataclasses

    import torch

    from vslam_tpu_torch.alignment import fused_ne, fused_solve, ic
    from vslam_tpu_torch.alignment.aligner import stack_frames
    from vslam_tpu_torch.core import se3
    from vslam_tpu_torch.core.camera import Camera
    from vslam_tpu_torch.core.se3 import SE3
    from vslam_tpu_torch.solvers import LossConfig, SolverConfig

    for F, P, what in ((1, 2048, "align_pairs / tracking_step"), (2, 2048, "odometry profiles and pipeline"),
                       (2, 32768, "the default 32768-point budget, F = 2")):
        log(f"phase 19 robust residual cache at F={F} P={P} ({what}): {_smem_path(F, P)[0]}")
    ref2 = stack_frames([frames["ref"], frames["mid"]], dim=1)
    cam = frames["ref"].cameras[0]
    data = ic.precompute_level(ref2.intensity[0], ref2.dIx[0], ref2.dIy[0], ref2.depth[0], cam,
                               _production_cfg().min_gradient, max_points=0)
    n_pairs, F, P = data.templ.shape
    device = data.templ.device
    xi = torch.as_tensor(xis * 0.5, dtype=torch.float32, device=device)
    mid = se3.exp(xi)
    rel = SE3(torch.stack([mid.R, torch.eye(3, device=device).expand(n_pairs, 3, 3)], 1).contiguous(),
              torch.stack([mid.t, torch.zeros(n_pairs, 3, device=device)], 1).contiguous())
    path, need, limit = _smem_path(F, P)
    err = {}
    for fn in ("Huber", "Tukey"):
        cfg = dataclasses.replace(_production_cfg(), loss=LossConfig(fn),
                                  solver=SolverConfig(DENSE_ITERATIONS, 1e-11, min_relative_reduction=1e-4))
        args = (data, rel, frames["cur"].intensity[0], frames["cur"].cameras[0], cfg, se3.log(rel))
        t0 = time.perf_counter()
        out_k = fused_solve.solve_level_fused(*args)
        _sync()
        t_k = time.perf_counter() - t0
        out_p = fused_solve.solve_level_fused_plain(*args)
        err[fn] = _solve_result_diff(out_k, out_p)
        log(f"phase 19 robust entry {fn}, {n_pairs} pairs' dense level 0: F={F} P={P} (F*P {F * P}), residual "
            f"cache in {path} (shared memory it would need {need} B, the card's limit {limit} B); "
            f"iterations {out_k[1].iterations.float().mean().item():.2f} mean (<= {DENSE_ITERATIONS}), valid "
            f"{int(out_k[1].valid.sum())}/{n_pairs}; kernel call {t_k:.3f} s; max abs difference from the "
            f"plain version {err[fn]:.3e}")
    del data, out_k, out_p
    if path != "global scratch" or any(e != 0.0 for e in err.values()):
        raise AssertionError(f"phase 19 robust: path {path}, differences {err}")

    rows, P, Hs, Ws = SAMPLE_ROWS, 8, 12, 16
    g = torch.Generator(device=device).manual_seed(3)
    z = 1.0 + torch.rand(rows // 2, 2, P, 1, device=device, generator=g)
    xy = (torch.rand(rows // 2, 2, P, 2, device=device, generator=g) - 0.5) * z
    mask = torch.rand(rows // 2, 2, P, device=device, generator=g) < 0.9
    level = ic.ICLevelData(pcl=torch.cat([xy, z], dim=-1).contiguous(),
                           J=torch.zeros(rows // 2, 2, P, 6, device=device),
                           templ=torch.zeros(rows // 2, 2, P, device=device), mask=mask,
                           n_constraints=mask.sum(-1).float())
    rel = SE3(torch.eye(3, device=device).expand(rows // 2, 2, 3, 3).contiguous(),
              torch.full((rows // 2, 2, 3), 0.01, device=device))
    cams = Camera(*(torch.full((rows // 2,), v, device=device) for v in (10.0, 10.0, (Ws - 1) / 2, (Hs - 1) / 2)))
    img = torch.rand(rows // 2, Hs, Ws, device=device, generator=g) * 255
    got = fused_ne.fused_level_sample(level, rel, img, cams, "bilinear")
    err["sample"] = _max_abs_diff(got, fused_ne.fused_level_sample_plain(level, rel, img, cams, "bilinear"))
    visible = got[1].float().mean().item()
    log(f"phase 19 fused_level_sample at {rows} (pair, frame) rows of {P} points ({Hs}x{Ws}): visible share "
        f"{visible:.3f}, last row sampled {bool(got[1][-1].any())}; max abs difference from the plain "
        f"version {err['sample']:.3e}")
    if err["sample"] != 0.0 or not bool(got[1][-1].any()):
        raise AssertionError(f"phase 19 sampler: difference {err['sample']}")
    return {"solve_level_fused_robust": max(err["Huber"], err["Tukey"]), "fused_level_sample": err["sample"]}


# phase 23: full SLAM on the noisy smooth stream, `bench.py:787-916` unchanged
SLAM_FRAMES = 64
SLAM_CHUNK = 16
# phase 23: how far the backend's state may move when matching and BA run on
# the card (compute_device "default") in place of the CPU ("auto"): f32
# arithmetic in another order, the same LM path
SLAM_BA_POSE_TOL = 1e-4  # rotation entries and metres
SLAM_POINT_TOL = 1e-3  # metres
# phase 24: the drift orbit, `bench.py:919-1045` unchanged
DRIFT_FRAMES = 256
# phases 24, 25: the worker's CUDA ops are counted in every 4th backend call
WORKER_OPS_EVERY = 4
# phase 25: the KITTI loop, `bench.py:1165-1300` unchanged
LOOP_FRAMES = 256
LOOP_SCALE = 5.0
# phase 26: the pose graph above pose_graph._DENSE_MAX_NODES
GRAPH_NODES = 900
GRAPH_MAX_CG = 4096  # the gated f64 PCG: CG's cap per LM step
GRAPH_F32_CAPS = (512, 256)  # the JAX test's cap and solver "auto"'s default
# the JAX package's accuracy records (BENCH_r05.json), quoted beside the port's
JAX_SLAM_ATE_M = 0.0011
JAX_DRIFT_ATES_M = (0.014, 0.0035, 0.014)  # odometry, anchored, online
JAX_LOOP_ATES_M = (0.0308, 0.0162, 0.0222)


@contextlib.contextmanager
def _logged(logger_name, level):
    """The messages of ``logger_name`` at ``level`` or above inside the block."""
    import logging

    messages = []

    class Keep(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    logger = logging.getLogger(logger_name)
    handler = Keep(level)
    logger.addHandler(handler)
    try:
        yield messages
    finally:
        logger.removeHandler(handler)


@contextlib.contextmanager
def _mapping_warnings(label):
    """Fail the phase if the mapping backend logs a warning inside the
    block: its graceful degradation must hide nothing on the card."""
    import logging

    with _logged("vslam_tpu_torch.mapping", logging.WARNING) as messages:
        yield
    if messages:
        raise AssertionError(f"{label}: the mapping backend warned: {messages[:5]}")


class _WorkerOps:
    """Counts, by thread, the ATen ops of a backend's process_chunk calls
    that touch a CUDA tensor and are not views (a view launches nothing),
    through a dispatch mode entered on the calling thread. With ``every``
    > 1 only every ``every``-th call is counted (the first among them): the
    mode slows the worker several times over, and the worker bounds the
    loop phases. ``counted_closures`` is the loop closures that the counted
    calls made."""

    def __init__(self, backend, every=1):
        import collections
        import itertools
        import threading

        import torch
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves

        self.by_thread = collections.Counter()
        counter = self.by_thread

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if not func.is_view and any(torch.is_tensor(t) and t.is_cuda
                                            for t in tree_leaves((args, kwargs, out))):
                    counter[threading.current_thread().name.split("_")[0]] += 1
                return out

        fn = backend.process_chunk
        calls = itertools.count()
        self.counted_calls = self.counted_closures = 0

        def counted(*a, **kw):
            if next(calls) % every:
                return fn(*a, **kw)
            before = backend.n_closures
            with Mode():
                out = fn(*a, **kw)
            self.counted_calls += 1
            self.counted_closures += backend.n_closures - before
            return out

        backend.process_chunk = counted


def _worker_ops(ops, label, log):
    """Log the CUDA ops that a `_WorkerOps` counted by thread and return the
    backend worker's (0 is expected under compute_device "auto": its loop
    closure and the retire-time stereo detection included). A sampled count
    must have seen a loop closure (else it returns -1)."""
    worker = ops.by_thread["mapping-backend"]
    log(f"{label}: CUDA ops (not views) of the backend calls by thread {dict(ops.by_thread)} over "
        f"{ops.counted_calls} counted calls (every {WORKER_OPS_EVERY}th), which made {ops.counted_closures} loop "
        f"closures; the worker's {worker} (expected 0 under compute_device auto, with a closure counted)")
    return worker if ops.counted_closures else -1


def _record_ba(backend):
    """Wrap the backend's BA to keep each solve's (poses, points) in a list,
    which it returns."""
    solves = []
    fn = backend._ba.optimize

    def optimize(slam_map):
        out = fn(slam_map)
        solves.append(out[:2])
        return out

    backend._ba.optimize = optimize
    return solves


def _backend_state_gaps(a, solves_a, b, solves_b):
    """How far two backends' states lie apart after the same chunks: the
    largest difference of their BA solves' keyframe poses (rotation entries
    and translations) and points, and of their landmark positions. Frame
    and landmark ids come from process-wide counters, so entries pair by
    order. Raises where the two differ in count."""
    if len(solves_a) != len(solves_b):
        raise AssertionError(f"{len(solves_a)} BA solves against {len(solves_b)}")

    def stacked(d):
        return np.stack([d[k] for k in sorted(d)]) if d else np.zeros((0, 3))

    pose_gap = point_gap = 0.0
    for (poses_a, points_a), (poses_b, points_b) in zip(solves_a, solves_b):
        for da, db in ((poses_a, poses_b), (points_a, points_b)):
            if len(da) != len(db):
                raise AssertionError(f"a BA solve over {len(da)} entries against {len(db)}")
        pose_gap = max(pose_gap, float(np.abs(stacked(poses_a)[:, :3] - stacked(poses_b)[:, :3]).max()))
        if points_a:
            point_gap = max(point_gap, float(np.abs(stacked(points_a) - stacked(points_b)).max()))
    pos_a = np.stack([p.position for p in a.map.points()])
    pos_b = np.stack([p.position for p in b.map.points()])
    if pos_a.shape != pos_b.shape:
        raise AssertionError(f"{len(pos_a)} landmarks against {len(pos_b)}")
    return pose_gap, point_gap, float(np.abs(pos_a - pos_b).max())


def _timed_backend(backend):
    """Wrap the backend's process_chunk to add its wall seconds into
    ``backend.busy_s`` (its thread's time, beside the scan)."""
    backend.busy_s = 0.0
    fn = backend.process_chunk

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            backend.busy_s += time.perf_counter() - t0

    backend.process_chunk = timed
    return backend


def _capture_levels(sink_by_width):
    """A `_tap` sink keeping the last solve inputs of each level width."""
    return lambda args, _: sink_by_width.__setitem__(args[2].shape[-1], args)


def _levels_vs_plain(captured, label, card, log):
    """Kernel 1 / 1b against its plain version at each level's captured
    inputs, bit for bit; returns the largest difference."""
    from vslam_tpu_torch.alignment import fused_solve

    max_err = 0.0
    for width, args in sorted(captured.items(), reverse=True):
        out_k = fused_solve.solve_level_fused(*args)
        err = _solve_result_diff(out_k, fused_solve.solve_level_fused_plain(*args))
        max_err = max(max_err, err)
        ms_k, seen = _kernel_device_ms(lambda: fused_solve.solve_level_fused(*args), 20, "solve_level_kernel")
        log(f"{label} kernel at the {args[2].shape[-2]}x{width} level's last inputs (F={args[0].templ.shape[1]}, "
            f"P={args[0].templ.shape[-1]}, {args[4].loss.function}, iterations {out_k[1].iterations.tolist()}): "
            f"max abs difference from the plain version {err:.3e}; {ms_k:.4f} ms on the device (profiler, "
            f"{seen} of 20 recorded) {card}")
    if max_err != 0.0:
        raise AssertionError(f"{label}: the kernel and its plain version differ by {max_err}")
    return max_err


def _backend_split(backend, wall, n_chunks, label, card, log):
    """The backend's host ms per chunk by stage (timer scopes) and its share
    of the wall time."""
    from vslam_tpu_torch.utils import timer

    parts = []
    for name in ("map.detect_batch", "map.track", "map.ba", "map.graph"):
        s = timer.stats(name)
        if s:
            parts.append(f"{name} {s['total_s'] * 1e3 / n_chunks:.2f} ms")
    log(f"{label} backend per chunk ({n_chunks} chunks, host clock of its thread): {', '.join(parts)}; "
        f"process_chunk busy {backend.busy_s:.3f} s of the {wall:.3f} s wall ({backend.busy_s / wall:.3f}) {card}")


def _detect_profile(backend, kf_js, images, camera, cfg, label, card, log):
    """One batched detection (`dispatch_detect`, its host copies included):
    device ms and launch calls (torch.profiler), peak memory above its
    inputs."""
    import torch
    from torch.autograd import DeviceType

    call = lambda: backend.dispatch_detect(kf_js, images, camera, cfg)  # noqa: E731
    ms, _ = _calls_device_ms(call, 3)
    calls = sum(1 for e in _profiled_events(call) if e.device_type == DeviceType.CPU
                and e.name.startswith(("cudaLaunch", "cuLaunch")))
    _sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    _sync()
    peak = torch.cuda.max_memory_allocated() - base
    log(f"{label}: {ms:.3f} ms on the device (profiler, all its kernels, mean of 3 calls), {calls} launch calls, "
        f"peak memory above its inputs {peak / 2**20:.1f} MiB {card}")


def _slam_stream():
    """`bench.py:787-832`: 64 noisy 480x640 frames of `smooth_trajectory(64,
    0.10, 0.04)` re-based on frame 0: depth noise 0.0012 + 0.0019 (z -
    0.4)^2 m, shot noise 1.5 gray levels, default_rng(7)."""
    from vslam_tpu_torch.core import lie_np
    from vslam_tpu_torch.io import synthetic

    K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    poses = synthetic.smooth_trajectory(SLAM_FRAMES, trans_amp=0.10, rot_amp=0.04)
    p0i = lie_np.inv(poses[0])
    poses = [p @ p0i for p in poses]
    clean = _render_all([lambda p=p: synthetic.render(K, p, (H, W)) for p in poses])
    rng = np.random.default_rng(7)
    stream = []
    for i, (inten, depth) in enumerate(clean):
        z = np.maximum(depth, 0.0)
        depth_n = z + rng.normal(0.0, 1.0, z.shape) * (0.0012 + 0.0019 * (z - 0.4) ** 2)
        inten_n = inten + rng.normal(0.0, 1.5, inten.shape)
        stream.append((i * DT_NS, np.clip(np.round(inten_n), 0, 255).astype(np.uint8),
                       np.clip(np.round(depth_n * 5000.0), 0, 65535).astype(np.uint16)))
    return poses, stream


def _slam(poses, stream, card, log):
    """Phase 23: `SequentialOdometry` with `ChunkMappingBackend(enable_ba=
    True)` over the noisy stream (the bench's slam gate): a mapping-off run,
    a warm-up whose worker's CUDA ops are counted (0 under "auto"), a
    streamed run, the best of 2 `run_staged`, each gated at ATE < 0.01 m;
    the staged replay again with compute_device "default"; kernel 1 against
    its plain version at each level's inputs. Returns (launches, kernel 1's
    largest difference)."""
    import dataclasses

    import torch

    from vslam_tpu_torch.alignment import fused_solve
    from vslam_tpu_torch.core import lie_np
    from vslam_tpu_torch.core.camera import Camera
    from vslam_tpu_torch.odometry.sequential import SequentialConfig, SequentialOdometry, stage_stream
    from vslam_tpu_torch.odometry.sequential_mapping import ChunkMappingBackend
    from vslam_tpu_torch.utils import timer

    cfg = SequentialConfig(alignment=dataclasses.replace(_production_cfg(), interpolation="bilinear"),
                           depth_scale=1.0 / 5000.0, n_levels=N_LEVELS, kf_period=5)
    camera = Camera.create(FX, FX, (W - 1) / 2, (H - 1) / 2)
    n = len(stream)
    n_chunks = -(-(n - 1) // SLAM_CHUNK)
    backend = lambda **kw: _timed_backend(ChunkMappingBackend(enable_ba=True, **kw))  # noqa: E731

    def run(mapping, staged=None):
        run.odo = SequentialOdometry(camera, cfg, chunk=SLAM_CHUNK, mapping=mapping)
        t0 = time.perf_counter()
        res = run.odo.run(iter(stream)) if staged is None else run.odo.run_staged(*staged)
        _sync()
        return res, time.perf_counter() - t0

    with _mapping_warnings("phase 23"):
        res_off, wall_off = run(None)
        ate_off = _ate(poses, res_off)
        warm = backend()
        ops = _WorkerOps(warm)
        run(warm)
        flags = run.odo.is_kf[1:]
        kf_chunks = sum(any(flags[s:s + SLAM_CHUNK]) for s in range(0, len(flags), SLAM_CHUNK))
        worker_ops = ops.by_thread["mapping-backend"]
        log(f"phase 23 slam warm-up: CUDA ops (not views) of the backend calls by thread {dict(ops.by_thread)}; "
            f"the worker's {worker_ops} (expected 0 under compute_device auto); batched detection "
            f"{warm.batched_detect_chunks} and matching {warm.batched_track_chunks} of the {kf_chunks} chunks "
            f"with keyframes")
        if worker_ops != 0 or not warm.batched_detect_chunks == warm.batched_track_chunks == kf_chunks:
            raise AssertionError(f"phase 23: worker CUDA ops {worker_ops} or an unbatched chunk")

        streamed = backend()
        _reset_launches()
        res_stream, wall_stream = run(streamed)
        launches = _launches()
        _frame_builds("23")
        ate_stream = _ate(poses, res_stream)
        first, chunks = stage_stream(iter(stream), SLAM_CHUNK)
        run(None, (first, chunks))
        walls_off = [run(None, (first, chunks))[1] for _ in range(2)]
        best, walls = None, []
        captured = {}
        for rep in range(2):
            b = backend()
            timer.reset()
            with _tap(fused_solve, "solve_level_fused", _capture_levels(captured)):
                res, wall = run(b, (first, chunks))
            walls.append(wall)
            if best is None or wall < best[2]:
                best = (b, res, wall, {k: timer.stats(k) for k in ("map.detect_batch", "map.track", "map.ba")})
        b_best, res_staged, wall_staged, _ = best
        ate_staged = _ate(poses, res_staged)
        log(f"phase 23 slam ({n} noisy frames at {H}x{W}, fused_gn bf16 bilinear 2048 points, kf_period 5, chunk "
            f"{SLAM_CHUNK}, ChunkMappingBackend(enable_ba=True)): ATE staged {ate_staged:.5f} m, streamed "
            f"{ate_stream:.5f} m (gate 0.01 each), mapping-off {ate_off:.5f} m (the JAX package's accuracy record "
            f"{JAX_SLAM_ATE_M} m); whole-level launches of the streamed run {launches} (expected "
            f"({N_LEVELS * (n - 1)}, 0)); landmarks {b_best.n_landmarks}, keyframes {sum(flags) + 1} (the "
            f"window holds {len(b_best.map.keyframes())}), {len(res_staged)} poses")
        log(f"phase 23 slam frames/s: staged {n / wall_staged:.2f} (best of {', '.join(f'{w:.3f}' for w in walls)} "
            f"s), streamed {n / wall_stream:.2f} ({wall_stream:.3f} s); mapping off: staged "
            f"{n / min(walls_off):.2f} (best of {', '.join(f'{w:.3f}' for w in walls_off)} s), streamed "
            f"{n / wall_off:.2f} ({wall_off:.3f} s) {card}")
        if not (ate_staged < 0.01 and ate_stream < 0.01) or launches != (N_LEVELS * (n - 1), 0):
            raise AssertionError(f"phase 23: ATE {ate_staged} / {ate_stream} or launches {launches} off")
        timer.reset()
        b = backend()
        solves = _record_ba(b)
        _, wall = run(b, (first, chunks))
        _backend_split(b, wall, n_chunks, "phase 23 slam staged", card, log)

        default = backend(compute_device="default")
        solves_default = _record_ba(default)
        res_default, wall_default = run(default, (first, chunks))
        gap = max(np.linalg.norm(lie_np.log(lie_np.relative(a[1], c[1]))) for a, c in zip(res_staged, res_default))
        ate_default = _ate(poses, res_default)
        state_gaps = _backend_state_gaps(b, solves, default, solves_default)
        log(f"phase 23 slam staged with compute_device default (matching, BA on the card): "
            f"{n / wall_default:.2f} frames/s against {n / wall_staged:.2f} with auto; ATE {ate_default:.5f} m; "
            f"largest per-frame pose difference from the auto run {gap:.3e}; against the auto run's backend "
            f"({len(solves)} BA solves, {b.n_landmarks} landmarks): BA keyframe poses {state_gaps[0]:.3e} (rotation "
            f"entries and m; gate {SLAM_BA_POSE_TOL}), BA points {state_gaps[1]:.3e} m, landmark positions "
            f"{state_gaps[2]:.3e} m (gate {SLAM_POINT_TOL} m each) {card}")
        if not ate_default < 0.01:
            raise AssertionError(f"phase 23: ATE {ate_default} with compute_device default")
        if not (solves and state_gaps[0] <= SLAM_BA_POSE_TOL and max(state_gaps[1:]) <= SLAM_POINT_TOL):
            raise AssertionError(f"phase 23: the backend's state with compute_device default parts from auto's: "
                                 f"{len(solves)} BA solves, gaps {state_gaps}")

    _detect_profile(b_best, None, (chunks[0].intensity, chunks[0].depth), camera, cfg,
                    f"phase 23 detection of a {len(chunks[0].stamps)}-frame chunk at {H}x{W}", card, log)
    err = _levels_vs_plain(captured, "phase 23 slam", card, log)
    return launches[0], err, res_stream


def _drift_stream(device):
    """`bench.py:965-986`: 256 frames of BoxScene(seed=4) along
    `orbit_trajectory(256, 0.4, 0.05, 0.12)`, rendered on the card."""
    from vslam_tpu_torch.io import synthetic

    K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    poses = synthetic.orbit_trajectory(DRIFT_FRAMES, radius=0.4, height=0.05, yaw=0.12)
    inten, depth = synthetic.render_boxes_batch(K, poses, (H, W), synthetic.BoxScene(seed=4), batch=16,
                                                device=device)
    stream = [(i * DT_NS, np.clip(np.round(inten[i]), 0, 255).astype(np.uint8),
               np.clip(np.round(depth[i] * 5000.0), 0, 65535).astype(np.uint16)) for i in range(len(poses))]
    return poses, stream


def _slam_drift(poses, stream, card, log):
    """Phase 24: the drift orbit (the bench's slam_drift gate): Huber,
    nearest, `fused_gn` (kernel 1b on the main path), mapping off, then BA +
    loop closure with pose_write_back "off", fold_min_span_frac 2.0 and
    LoopClosureConfig(4, 10, 8). Gate: closures >= 1, mapping-off ATE >
    0.01 m, corrected < 0.6 x mapping-off, online <= 1.02 x mapping-off;
    kernel 1b against its plain version at each level's inputs. Returns
    (robust launches, kernel 1b's largest difference)."""
    from vslam_tpu_torch.alignment import fused_solve
    from vslam_tpu_torch.core.camera import Camera
    from vslam_tpu_torch.features.loop_closure import LoopClosureConfig
    from vslam_tpu_torch.odometry.sequential import SequentialOdometry
    from vslam_tpu_torch.odometry.sequential_mapping import ChunkMappingBackend

    cfg = _odometry_cfg("robust")  # Huber, nearest, fused_gn bf16 2048 points, kf_period 5
    camera = Camera.create(FX, FX, (W - 1) / 2, (H - 1) / 2)
    n = len(stream)
    with _mapping_warnings("phase 24"):
        t0 = time.perf_counter()
        res_off = SequentialOdometry(camera, cfg, chunk=SLAM_CHUNK).run(iter(stream))
        _sync()
        wall_off = time.perf_counter() - t0
        ate_off = _ate(poses, res_off)
        backend = _timed_backend(ChunkMappingBackend(enable_ba=True, enable_loop_closure=True,
                                                     pose_write_back="off", fold_min_span_frac=2.0,
                                                     loop_closure_cfg=LoopClosureConfig(min_gap=4, min_matches=10,
                                                                                        min_inliers=8)))
        ops = _WorkerOps(backend, WORKER_OPS_EVERY)
        captured = {}
        _reset_launches()
        t0 = time.perf_counter()
        with _tap(fused_solve, "solve_level_fused", _capture_levels(captured)):
            res = SequentialOdometry(camera, cfg, chunk=SLAM_CHUNK, mapping=backend).run(iter(stream))
        _sync()
        wall = time.perf_counter() - t0
        launches = _launches()
        _frame_builds("24")
    ate_online = _ate(poses, res)
    ate_corr = _ate(poses, backend.corrected_trajectory(res))
    worker_ops = _worker_ops(ops, "phase 24 slam_drift", log)
    win = (backend.n_closures >= 1 and ate_off > 0.01 and ate_corr < 0.6 * ate_off
           and ate_online <= 1.02 * ate_off)
    log(f"phase 24 slam_drift ({n} frames of the box orbit at {H}x{W}, Huber nearest fused_gn): mapping-off ATE "
        f"{ate_off:.5f} m, corrected {ate_corr:.5f} m (gate < 0.6 x off = {0.6 * ate_off:.5f}), online "
        f"{ate_online:.5f} m (gate <= 1.02 x off); {backend.n_closures} closures, {backend.n_landmarks} landmarks; "
        f"the JAX package's accuracy records (odometry, anchored, online) {JAX_DRIFT_ATES_M} m; robust launches "
        f"{launches[1]} (expected {N_LEVELS * (n - 1)}); {'WIN' if win else 'FAILED'}")
    log(f"phase 24 slam_drift frames/s: {n / wall:.2f} with the backend ({wall:.3f} s, process_chunk busy "
        f"{backend.busy_s:.3f} s, the CUDA ops of every {WORKER_OPS_EVERY}th call counted), {n / wall_off:.2f} "
        f"mapping off ({wall_off:.3f} s), streamed {card}")
    if not win or launches != (0, N_LEVELS * (n - 1)) or worker_ops != 0:
        raise AssertionError(f"phase 24: the slam_drift gate failed, launches {launches} off or the worker's CUDA "
                             f"ops {worker_ops}")
    err = _levels_vs_plain(captured, "phase 24 slam_drift", card, log)
    return launches[1], err


def _loop_stream(device):
    """`bench.py:1214-1233`: 256 stereo pairs at 1241x376 along
    `loop_trajectory(256, 3.0, 0.3, 0.25)` in the street-scale BoxScene,
    rendered on the card without depth; the right camera 0.5372 m along +x."""
    from vslam_tpu_torch.io import synthetic

    K = synthetic.camera_matrix(*KITTI_CAM)
    scene = synthetic.BoxScene(seed=4, scale=LOOP_SCALE, background=synthetic.PlaneScene(
        normal=(0.0, -0.25, 1.0), d=2.5 * LOOP_SCALE, origin=(0.0, 0.0, 2.5 * LOOP_SCALE), n_waves=12))
    poses = synthetic.loop_trajectory(LOOP_FRAMES, extent=3.0, height=0.3, yaw=0.25)
    right = np.eye(4)
    right[:3, 3] = [-KITTI_BASELINE, 0.0, 0.0]
    inten, _ = synthetic.render_boxes_batch(K, list(poses) + [right @ p for p in poses], (KITTI_H, KITTI_W), scene,
                                            batch=8, with_depth=False, device=device)
    inten = _u8(inten)
    return poses, [(i * KITTI_DT_NS, inten[i], inten[LOOP_FRAMES + i]) for i in range(LOOP_FRAMES)]


def _kitti_loop(poses, stream, card, log):
    """Phase 25: the KITTI loop (the bench's kitti_loop gate): the KITTI
    profile of phase 20, mapping off, then BA + loop closure with
    LoopClosureConfig(max(6, N // 40), 10, 8). Gate: closures >= 1,
    mapping-off ATE > 0.02 m, corrected < 0.6 x mapping-off. Also the graph
    solve's telemetry and the stereo detection batch's peak memory. Returns
    (launches, kernel 1's largest difference)."""
    import torch

    from vslam_tpu_torch.alignment import fused_solve
    from vslam_tpu_torch.core.camera import Camera
    from vslam_tpu_torch.features.loop_closure import LoopClosureConfig
    from vslam_tpu_torch.odometry.sequential import SequentialOdometry, stage_stream
    from vslam_tpu_torch.odometry.sequential_mapping import ChunkMappingBackend
    from vslam_tpu_torch.utils import timer

    cfg = _kitti_cfg()
    camera = Camera.create(*KITTI_CAM)
    n = len(stream)
    with _mapping_warnings("phase 25"):
        t0 = time.perf_counter()
        res_off = SequentialOdometry(camera, cfg, chunk=KITTI_CHUNK).run(iter(stream))
        _sync()
        wall_off = time.perf_counter() - t0
        ate_off = _kitti_ate(poses, res_off)
        backend = _timed_backend(ChunkMappingBackend(enable_ba=True, enable_loop_closure=True,
                                                     loop_closure_cfg=LoopClosureConfig(
                                                         min_gap=max(6, n // 40), min_matches=10, min_inliers=8)))
        ops = _WorkerOps(backend, WORKER_OPS_EVERY)
        captured = {}
        timer.reset()
        _reset_launches()
        t0 = time.perf_counter()
        with _tap(fused_solve, "solve_level_fused", _capture_levels(captured)):
            res = SequentialOdometry(camera, cfg, chunk=KITTI_CHUNK, mapping=backend).run(iter(stream))
        _sync()
        wall = time.perf_counter() - t0
        launches = _launches()
        _frame_builds("25")
    ate_online = _kitti_ate(poses, res)
    ate_corr = _kitti_ate(poses, backend.corrected_trajectory(res))
    worker_ops = _worker_ops(ops, "phase 25 kitti_loop", log)
    g = backend._graph
    win = backend.n_closures >= 1 and ate_off > 0.02 and ate_corr < 0.6 * ate_off
    log(f"phase 25 kitti_loop ({n} stereo pairs at {KITTI_W}x{KITTI_H}, the KITTI profile): mapping-off ATE "
        f"{ate_off:.5f} m, corrected {ate_corr:.5f} m (gate < 0.6 x off = {0.6 * ate_off:.5f}), online "
        f"{ate_online:.5f} m; {backend.n_closures} closures, {backend.n_landmarks} landmarks; the JAX package's "
        f"accuracy records (odometry, anchored, online) {JAX_LOOP_ATES_M} m; graph: {g.last_solve_nodes} nodes, "
        f"last solve {g.last_solve_s:.3f} s, slowest {g.max_solve_s:.3f} s; launches {launches} (expected "
        f"({KITTI_LEVELS * (n - 1)}, 0)); {'WIN' if win else 'FAILED'}")
    log(f"phase 25 kitti_loop frames/s: {n / wall:.2f} with the backend ({wall:.3f} s, the CUDA ops of every "
        f"{WORKER_OPS_EVERY}th call counted), "
        f"{n / wall_off:.2f} mapping off ({wall_off:.3f} s), streamed {card}")
    _backend_split(backend, wall, -(-(n - 1) // KITTI_CHUNK), "phase 25 kitti_loop streamed", card, log)
    if not win or launches != (KITTI_LEVELS * (n - 1), 0) or worker_ops != 0:
        raise AssertionError(f"phase 25: the kitti_loop gate failed, launches {launches} off or the worker's CUDA "
                             f"ops {worker_ops}")
    # the stereo detection batch: a chunk's keyframes, block matching included
    first, chunks = stage_stream(iter(stream[:KITTI_CHUNK + 1]), KITTI_CHUNK)
    kf_js = list(range(4, KITTI_CHUNK, 5))
    _detect_profile(backend, kf_js, (chunks[0].intensity, chunks[0].depth), camera, cfg,
                    f"phase 25 stereo detection of {len(kf_js)} keyframes at {KITTI_W}x{KITTI_H} (block matching "
                    f"included)", card, log)
    err = _levels_vs_plain(captured, "phase 25 kitti_loop", card, log)
    return launches[0], err


def _big_graph(device):
    """A chain of GRAPH_NODES noisy odometry edges (information 1) with five
    exact long-range loop edges (information 100), initialized by
    integrating the noisy odometry: `tests/test_pose_graph.py::
    test_pcg_large_chain_with_loops` at 900 nodes."""
    import torch

    from vslam_tpu_torch.ba.pose_graph import PoseGraph
    from vslam_tpu_torch.core import lie_np
    from vslam_tpu_torch.core.se3 import SE3

    K = GRAPH_NODES
    rng = np.random.default_rng(7)
    gt = [np.eye(4)]
    step = np.array([0.4, 0.0, 0.05, 0.0, 2 * np.pi / K, 0.0])
    for _ in range(1, K):
        gt.append(lie_np.exp(step) @ gt[-1])
    edges = [(k, k + 1, lie_np.exp(rng.normal(0, 0.01, 6)) @ lie_np.relative(gt[k], gt[k + 1]), 1.0)
             for k in range(K - 1)]
    loops = [(K - 1, 0), (K // 2, 0), (3 * K // 4, K // 4), (K - 1, K // 2), (K // 3, 0)]
    edges += [(a, b, lie_np.relative(gt[a], gt[b]), 100.0) for a, b in loops]
    init = [np.eye(4)]
    for k in range(K - 1):
        init.append(edges[k][2] @ init[-1])
    f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64, device=device)  # noqa: E731
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)  # noqa: E731
    return PoseGraph(SE3(f64([T[:3, :3] for T in init]), f64([T[:3, 3] for T in init])),
                     i64([e[0] for e in edges]), i64([e[1] for e in edges]),
                     SE3(f64([e[2][:3, :3] for e in edges]), f64([e[2][:3, 3] for e in edges])),
                     f64([np.eye(6) * e[3] for e in edges]), torch.ones(len(edges), dtype=torch.bool, device=device))


def _graph_at_scale(device, card, log):
    """Phase 26: the 900-node five-loop chain on the card, by PCG (the path
    solver "auto" takes above 768 nodes) and by the dense solve (a 5400 x
    5400 Hessian). Gated in f64, as `test_pcg_matches_dense`: initial chi2
    within rtol 1e-5, PCG's final chi2 < 0.1 x its initial, translations
    within 5e-3, with CG capped at GRAPH_MAX_CG iterations a step (rtol
    1e-8). In f32 the optimum is not determined to 5e-3 (the f32 dense
    solve lands ~0.2 m from the f64 one), and PCG at the caps
    GRAPH_F32_CAPS stalls far above it, as the JAX function does on the
    same graph (`tests/test_torch_pose_graph.py`): those runs are reported
    beside the f64 ones, an open fault (ROADMAP Queue 3), not gated."""
    import torch

    from vslam_tpu_torch.ba import pose_graph
    from vslam_tpu_torch.core.se3 import SE3

    g = _big_graph(device)

    def solve(graph, solver, max_cg=0):
        kw = {"max_cg": max_cg, "cg_rtol": 1e-8} if solver == "pcg" else {}
        t0 = time.perf_counter()
        opt, c0, c1 = pose_graph.optimize_pose_graph(graph, solver=solver, **kw)
        _sync()
        return opt, float(c0), float(c1), time.perf_counter() - t0, pose_graph.optimize_pose_graph.cg_iterations

    (od, d0, d1, td, _), (op, p0, p1, tp, cg) = solve(g, "dense"), solve(g, "pcg", GRAPH_MAX_CG)
    gap = float((op.t - od.t).abs().max())
    log(f"phase 26 pose graph, the five-loop chain: {GRAPH_NODES} nodes, {g.edge_i.shape[0]} edges on the card, "
        f"f64: PCG (cap {GRAPH_MAX_CG}) chi2 {p0:.6g} -> {p1:.6g} in {tp:.3f} s, {cg} CG iterations; dense "
        f"({6 * GRAPH_NODES} x {6 * GRAPH_NODES}) chi2 {d0:.6g} -> {d1:.6g} in {td:.3f} s; translations PCG against "
        f"dense {gap:.3e} m (gate 5e-3) {card}")
    if not (abs(p0 - d0) <= 1e-5 * abs(d0) and p1 < 0.1 * p0 and gap < 5e-3):
        raise AssertionError(f"phase 26: PCG and the dense solve disagree: chi2 {p0} -> {p1} against {d0} -> {d1}, "
                             f"translations {gap} m apart")
    g32 = g._replace(poses=SE3(g.poses.R.float(), g.poses.t.float()),
                     edge_rel=SE3(g.edge_rel.R.float(), g.edge_rel.t.float()), edge_info=g.edge_info.float())
    runs = [("dense", solve(g32, "dense"))] + [(f"PCG cap {c}", solve(g32, "pcg", c)) for c in GRAPH_F32_CAPS]
    log("phase 26 pose graph, the five-loop chain in f32 (open fault, not gated): " + "; ".join(
        f"{name} chi2 {c1:.6g} in {t:.3f} s ({it} CG iterations), translations {float((o.t.double() - od.t).abs().max()):.3e} "
        f"m from the f64 dense solve" for name, (o, _, c1, t, it) in runs) + f" {card}")


# phase 27: the viewer, checkpoint / resume and profiling on the main path
RESUME_SPLIT = 32  # frames of the odometry profile before the checkpoint
RESUME_POSE_TOL = 1e-4  # tests/test_checkpoint.py's gate, SE(3) distance


def _http(port, path):
    """GET http://127.0.0.1:port/path with a 5 s timeout."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        if r.status != 200:
            raise AssertionError(f"GET {path}: status {r.status}")
        return r.read()


@contextlib.contextmanager
def _recording_viewers():
    """While the block runs, every `LiveViz` an entry point builds (they
    import it from `vslam_tpu_torch.viz` when they need one) is kept in the
    list the block gets, and closed at its end."""
    import vslam_tpu_torch.viz as viz_pkg

    made, cls = [], viz_pkg.LiveViz

    class Recording(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    viz_pkg.LiveViz = Recording
    try:
        yield made
    finally:
        viz_pkg.LiveViz = cls
        for v in made:
            v.close()


def _viewer_slam(slam_poses, slam_stream, slam_streamed, card, log):
    """Phase 27 (a): phase 23's streamed SLAM run with `LiveViz(port=0)`,
    beside the same run without it; the viewer's state over HTTP against
    the run. Returns (launches, viewer run's backend)."""
    import dataclasses

    from vslam_tpu_torch.core import lie_np
    from vslam_tpu_torch.core.camera import Camera
    from vslam_tpu_torch.odometry.sequential import SequentialConfig, SequentialOdometry
    from vslam_tpu_torch.odometry.sequential_mapping import ChunkMappingBackend
    from vslam_tpu_torch.viz import LiveViz

    cfg = SequentialConfig(alignment=dataclasses.replace(_production_cfg(), interpolation="bilinear"),
                           depth_scale=1.0 / 5000.0, n_levels=N_LEVELS, kf_period=5)
    camera = Camera.create(FX, FX, (W - 1) / 2, (H - 1) / 2)
    n = len(slam_stream)

    def run(viz):
        backend = ChunkMappingBackend(enable_ba=True)
        odo = SequentialOdometry(camera, cfg, chunk=SLAM_CHUNK, mapping=backend, viz=viz)
        _reset_launches()
        _sync()
        t0 = time.perf_counter()
        res = odo.run(iter(slam_stream))
        _sync()
        return res, time.perf_counter() - t0, _launches(), odo, backend

    viz = LiveViz(port=0)
    spent = [0.0]  # the host's seconds inside the viewer's publish calls

    def timed(fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[0] += time.perf_counter() - t0
        return call

    for name in ("publish_odometry", "publish_keyframe", "publish_landmarks"):
        setattr(viz, name, timed(getattr(viz, name)))
    try:
        with _mapping_warnings("phase 27 (a)"):
            # in turns, so that both share the host's state: off, on, on, off
            res_off, wall_off, launches_off, _, _ = run(None)
            res, wall, launches, odo, backend = run(viz)
            _frame_builds("27")
            state = json.loads(_http(viz.port, "/state.json"))
            page = _http(viz.port, "/").decode()
            publish_s = spent[0]
            wall_on2 = run(viz)[1]
            wall_off2 = run(None)[1]
    finally:
        viz.close()
    T_last = lie_np.inv(res[-1][1])
    same_23 = sum(np.array_equal(a[1], b[1]) and a[0] == b[0] for a, b in zip(res, slam_streamed))
    same_off = sum(np.array_equal(a[1], b[1]) for a, b in zip(res, res_off))
    pos_err = float(np.abs(np.asarray(state["position"]) - T_last[:3, 3]).max())
    ate = _ate(slam_poses, res)
    log(f"phase 27 (a) slam with LiveViz(port=0), {n} noisy frames at {H}x{W} (phase 23's run): whole-level "
        f"launches {launches} (expected ({N_LEVELS * (n - 1)}, 0); without the viewer {launches_off}); poses "
        f"bit-equal to phase 23's streamed run {same_23}/{len(slam_streamed)}, to this phase's run without the "
        f"viewer {same_off}/{len(res_off)}; ATE {ate:.5f} m; /state.json: n_frames {state['n_frames']}, "
        f"n_keyframes {state['n_keyframes']} (the run's flags {sum(odo.is_kf)}), n_landmarks "
        f"{state['n_landmarks']} (the map's {backend.n_landmarks}), t_ns {state['t_ns']} (last pose "
        f"{res[-1][0]}), position off the last camera-in-world by {pos_err:.3e} m; GET / {len(page)} bytes")
    log(f"phase 27 (a) slam frames/s streamed, runs in turns off, on, on, off: with the viewer "
        f"{n / wall:.2f}, {n / wall_on2:.2f} ({wall:.3f}, {wall_on2:.3f} s), without {n / wall_off:.2f}, "
        f"{n / wall_off2:.2f} ({wall_off:.3f}, {wall_off2:.3f} s); the publish calls of the first run with the "
        f"viewer took {publish_s * 1e3:.3f} ms of host time ({publish_s * 1e6 / n:.1f} us a frame) {card}")
    ok = (state["n_frames"] == n and state["n_keyframes"] == sum(odo.is_kf) and state["t_ns"] == res[-1][0]
          and pos_err <= 1e-6 and state["n_landmarks"] > 0 and launches == (N_LEVELS * (n - 1), 0)
          and same_23 == len(res) == len(slam_streamed) and "<svg" in page and "state.json" in page)
    if not ok:
        raise AssertionError(f"phase 27 (a): the viewer's state, the launches or the poses are off: {state}")
    return launches[0], backend


def _resume(poses, stream, card, log):
    """Phase 27 (b): the odometry profile's 64 frames, checkpointed after
    RESUME_SPLIT and resumed in a fresh SequentialOdometry from a fresh state, against
    the uninterrupted run. Returns the split runs' launches."""
    import os
    import tempfile

    import torch

    from vslam_tpu_torch.core import lie_np
    from vslam_tpu_torch.core.camera import Camera
    from vslam_tpu_torch.odometry.sequential import SequentialOdometry, init_state
    from vslam_tpu_torch.utils import checkpoint
    from vslam_tpu_torch.utils.tree import tree_leaves

    chunk = PROFILES["odometry"][0]
    cfg = _odometry_cfg("odometry")
    camera = Camera.create(FX, FX, (W - 1) / 2, (H - 1) / 2)
    full = SequentialOdometry(camera, cfg, chunk=chunk).run(iter(stream))
    _reset_launches()
    odo1 = SequentialOdometry(camera, cfg, chunk=chunk)
    first = odo1.run(iter(stream[:RESUME_SPLIT]))
    saved = tree_leaves(odo1.state)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "state.npz")
        _sync()
        t0 = time.perf_counter()
        checkpoint.save_sequential(path, odo1.state, odo1._t_last_ns)
        save_ms = (time.perf_counter() - t0) * 1e3
        size = os.path.getsize(path)
        odo2 = SequentialOdometry(camera, cfg, chunk=chunk)
        like = init_state(stream[0][1], stream[0][2], camera, cfg)
        _sync()
        t0 = time.perf_counter()
        state, t_last = checkpoint.load_sequential(path, like)
        _sync()
        load_ms = (time.perf_counter() - t0) * 1e3
    loaded = tree_leaves(state)
    placed = all(a.device == camera.fx.device and a.dtype == b.dtype for a, b in zip(loaded, saved))
    equal = all(torch.equal(a, b) for a, b in zip(loaded, saved))
    odo2.state, odo2._t_last_ns = state, t_last
    resumed = first + odo2.run(iter(stream[RESUME_SPLIT:]))
    _sync()
    launches = _launches()
    _frame_builds("27")
    gaps = [float(np.linalg.norm(lie_np.log(lie_np.relative(a[1], b[1])))) for a, b in zip(resumed, full)]
    same = sum(np.array_equal(a[1], b[1]) for a, b in zip(resumed, full))
    dtypes = sorted({str(x.dtype).removeprefix("torch.") for x in saved})
    log(f"phase 27 (b) checkpoint after {RESUME_SPLIT} of {len(stream)} frames at {H}x{W} (odometry profile, fused_gn "
        f"bf16): {len(saved)} leaves ({', '.join(dtypes)}; bf16 leaves {sum(x.dtype == torch.bfloat16 for x in saved)}: "
        f"the state keeps f32 templates, the solve samples a bf16 copy of the image), every loaded leaf on "
        f"{camera.fx.device} with its saved dtype {placed}, equal to the saved state {equal}; file {size} bytes, save {save_ms:.1f} ms, "
        f"load {load_ms:.1f} ms {card}")
    log(f"phase 27 (b) resumed against uninterrupted: stamps equal {[r[0] for r in resumed] == [r[0] for r in full]}, "
        f"largest pose gap {max(gaps):.3e} (gate {RESUME_POSE_TOL}), bit-equal poses {same}/{len(full)}; whole-level "
        f"launches of the two halves {launches} (expected ({N_LEVELS * (len(stream) - 1)}, 0))")
    if not (placed and equal and [r[0] for r in resumed] == [r[0] for r in full] and max(gaps) < RESUME_POSE_TOL
            and launches == (N_LEVELS * (len(stream) - 1), 0)):
        raise AssertionError(f"phase 27 (b): the resumed scan is off: gap {max(gaps)}, launches {launches}")
    return launches[0]


def _landmarks_round_trip(backend, log):
    """Phase 27 (b), its map: the slam run's landmarks through
    save_landmarks / load_landmarks."""
    import os
    import tempfile

    from vslam_tpu_torch.utils import checkpoint

    lms = backend.map.points()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "landmarks.npz")
        checkpoint.save_landmarks(path, lms)
        back = checkpoint.load_landmarks(path)
        size = os.path.getsize(path)
    same = (len(back) == len(lms) > 0 and [b.id for b in back] == [a.id for a in lms]
            and np.array_equal(np.stack([b.position for b in back]), np.stack([a.position for a in lms])))
    log(f"phase 27 (b) landmarks of the slam run: {len(lms)} saved, {len(back)} loaded, ids and positions equal "
        f"{same}; file {size} bytes")
    if not same:
        raise AssertionError("phase 27 (b): the landmarks did not round-trip")


def _viewer_pipeline(poses, stream, device, card, log):
    """Phase 27 (c): phase 17's `enable_mapping` run with live_viz_port=0."""
    import dataclasses

    from vslam_tpu_torch.config import PipelineConfig
    from vslam_tpu_torch.core.camera import Camera
    from vslam_tpu_torch.odometry.pipeline import OdometryPipeline

    cfg = PipelineConfig(sampler="fused_gn", image_dtype="bfloat16", features_max_points=2048, enable_mapping=True)
    cfg = dataclasses.replace(cfg, live_viz_port=0)
    mapped = stream[:PIPE_MAPPING_FRAMES]
    pipe = OdometryPipeline(Camera(FX, FX, (W - 1) / 2, (H - 1) / 2), cfg, device=device)
    try:
        with _mapping_warnings("phase 27 (c)"):
            _reset_launches()
            t0 = time.perf_counter()
            traj = pipe.run(iter(mapped))
            _sync()
            wall = time.perf_counter() - t0
            launches = _launches()
            _frame_builds("27")
        state = json.loads(_http(pipe.viz.port, "/state.json"))
    finally:
        pipe.viz.close()
    ate = _trajectory_ate(poses[:len(mapped)], traj)
    log(f"phase 27 (c) pipeline with enable_mapping and live_viz_port=0: {len(mapped)} frames, viewer n_frames "
        f"{state['n_frames']}, n_keyframes {state['n_keyframes']}, n_landmarks {state['n_landmarks']}; whole-level "
        f"launches {launches} (expected ({N_LEVELS * (len(mapped) - 1)}, 0)); ATE {ate:.5f} m (gate 0.01); "
        f"{len(mapped) / wall:.2f} frames/s {card}")
    if not (state["n_frames"] == len(mapped) and state["n_landmarks"] > 0 and ate < 0.01
            and launches == (N_LEVELS * (len(mapped) - 1), 0)):
        raise AssertionError(f"phase 27 (c): viewer {state['n_frames']} frames, {state['n_landmarks']} landmarks, "
                             f"ATE {ate}, launches {launches}")
    return launches[0]


def _viewer_cli(tum_sets, card, log):
    """Phase 27 (d): `synthetic --live-viz 0` at 480x640 on the host loop
    and with --fused --mapping, and `odometry` with two --dataset values
    and --live-viz 0 (a warning, no viewer). Returns the launches."""
    import logging
    import os
    import tempfile

    launches = 0
    for flags in ([], ["--fused", "--mapping"]):
        with _recording_viewers() as made, _mapping_warnings(f"phase 27 (d) synthetic {flags}"):
            _reset_launches()
            rc, lines = _cli_json(["synthetic", "--frames", str(CLI_FRAMES), "--height", str(H), "--width", str(W),
                                   "--fx", str(FX), "--live-viz", "0", *flags])
            launches += _launches()[0]
            _frame_builds("27")
            frames = [v.state()["n_frames"] for v in made]
        (res,) = [json.loads(line) for line in lines if line.startswith("{")]
        log(f"phase 27 (d) CLI synthetic --live-viz 0 {' '.join(flags) or '(host loop)'}: exit {rc}, {res}; the "
            f"viewer's n_frames {frames} {card}")
        if rc != 0 or not res["ate_rmse_m"] < 0.01 or frames != [CLI_FRAMES]:
            raise AssertionError(f"phase 27 (d) synthetic {flags}: exit {rc}, {res}, viewers {frames}")
    if not _png_reader():
        log("phase 27 (d) CLI odometry suite --live-viz 0: not run, no PNG reader here")
        return launches
    with tempfile.TemporaryDirectory() as d:
        tums = [os.path.join(d, f"tum{k}") for k in range(2)]
        for root, (poses, stream) in zip(tums, tum_sets):
            _write_tum(root, poses, stream[:PIPE_SHORT_FRAMES])
        with _recording_viewers() as made, _logged("vslam_tpu_torch.system", logging.WARNING) as warned:
            _reset_launches()
            rc, lines = _cli_json(["odometry", "--dataset", tums[0], "--dataset", tums[1], "--intrinsics",
                                   f"{FX},{FX},{(W - 1) / 2},{(H - 1) / 2}", "--fused", "--live-viz", "0",
                                   "--out", os.path.join(d, "suite.txt")])
            launches += _launches()[0]
            _frame_builds("27")
    said = [m for m in warned if "--live-viz is not supported" in m]
    log(f"phase 27 (d) CLI odometry suite of two TUM directories --live-viz 0: exit {rc}, warned {said}, viewers "
        f"built {len(made)}")
    if rc != 0 or not said or made:
        raise AssertionError(f"phase 27 (d) suite: exit {rc}, warning {said}, viewers {len(made)}")
    return launches


def _profiled_chunk(slam_stream, card, log):
    """Phase 27 (e): `trace()` around one scan chunk with the viewer on,
    whose publishing runs under `annotate("viz.publish")`."""
    import dataclasses
    import os
    import tempfile

    from vslam_tpu_torch.core.camera import Camera
    from vslam_tpu_torch.odometry.sequential import SequentialConfig, SequentialOdometry
    from vslam_tpu_torch.utils import profiling
    from vslam_tpu_torch.viz import LiveViz

    cfg = SequentialConfig(alignment=dataclasses.replace(_production_cfg(), interpolation="bilinear"),
                           depth_scale=1.0 / 5000.0, n_levels=N_LEVELS, kf_period=5)
    viz = LiveViz(port=0)
    try:
        odo = SequentialOdometry(Camera.create(FX, FX, (W - 1) / 2, (H - 1) / 2), cfg, chunk=SLAM_CHUNK, viz=viz)
        with tempfile.TemporaryDirectory() as d:
            with profiling.trace(d):
                _reset_launches()
                odo.run(iter(slam_stream[:SLAM_CHUNK + 1]))
                _sync()
                launches = _launches()
                _frame_builds("27")
            with open(os.path.join(d, "trace.json")) as f:
                events = json.load(f)["traceEvents"]
    finally:
        viz.close()
    spans = [e for e in events if e.get("name") == "viz.publish"]
    kernels = sum(1 for e in events if "solve_level_kernel" in str(e.get("name")))
    log(f"phase 27 (e) trace() of one {SLAM_CHUNK}-frame chunk with the viewer: {len(events)} events, "
        f"'viz.publish' spans {len(spans)} ({sum(e.get('dur', 0) for e in spans):.0f} us), solve_level_kernel "
        f"events {kernels}; whole-level launches {launches} {card}")
    if not spans or launches != (N_LEVELS * SLAM_CHUNK, 0):
        raise AssertionError(f"phase 27 (e): no viz.publish span in trace.json or launches {launches}")
    return launches[0]


def _memory_after(label, card, log):
    """Phase 27 (e): `device_memory_stats()` after a phase."""
    from vslam_tpu_torch.utils.profiling import device_memory_stats

    stats = device_memory_stats()
    log(f"phase 27 (e) device_memory_stats() after {label}: bytes_in_use {stats.get('bytes_in_use')}, peak "
        f"{stats.get('peak_bytes_in_use', 0) / 2**20:.1f} MiB, reserved {stats.get('bytes_reserved', 0) / 2**20:.1f} "
        f"MiB, limit {stats.get('bytes_limit', 0) / 2**30:.2f} GiB {card}")
    if not (stats.get("bytes_in_use", 0) > 0 and stats["peak_bytes_in_use"] >= stats["bytes_in_use"]):
        raise AssertionError(f"phase 27 (e): device_memory_stats {stats}")


def _viewer_and_resume(slam, odometry, robust, device, card, log):
    """Phase 27: (a) the slam run with the viewer, (b) checkpoint / resume
    and the landmark files, (c) the pipeline's viewer, (d) the CLI's
    --live-viz, (e) trace() with annotate and device_memory_stats. Returns
    the phase's kernel-1 launches."""
    slam_poses, slam_stream, slam_streamed = slam
    launches, backend = _viewer_slam(slam_poses, slam_stream, slam_streamed, card, log)
    _memory_after("(a)", card, log)
    launches += _resume(*odometry, card, log)
    _landmarks_round_trip(backend, log)
    launches += _viewer_pipeline(*odometry, device, card, log)
    launches += _viewer_cli([odometry, robust], card, log)
    launches += _profiled_chunk(slam_stream, card, log)
    return launches


# phase 28: the mesh
MESH_RANKS = 2  # processes sharing the card in (b)
MESH_TIMEOUT_S = 300  # (b)'s group timeout and its ranks' wall limit
MESH_POSE_TOL = 1e-3  # (b) against (a): per pair and per pose, SE(3) log


def _lazy_stream(make):
    """A stream whose frames are made (``make()``) at its first pull."""
    yield from make()


def _trajectory_gap(got, want):
    """(largest per-frame SE(3) gap, bit-equal poses and covariances) of two
    runs' trajectories, sequence by sequence."""
    from vslam_tpu_torch.core import lie_np

    gap, same = 0.0, True
    for a, b in zip(got, want, strict=True):
        if [r[0] for r in a] != [r[0] for r in b]:
            return float("inf"), False
        for (_, Ta, Ca), (_, Tb, Cb) in zip(a, b):
            gap = max(gap, float(np.linalg.norm(lie_np.log(lie_np.relative(Ta, Tb)))))
            same = same and np.array_equal(Ta, Tb) and np.array_equal(Ca, Cb)
    return gap, same


def _mesh_one(frames, track, suite_streams, suite_run, card, log):
    """Phase 28 (a): an NCCL group of one in this process on cuda:0.
    ``track`` is phase 6's (ekf0, dts, cfg, (ekf, rel, valid)); ``suite_run``
    phase 21's counted run of ``suite_streams``. Returns ((quadratic,
    robust) launches, the kernels' largest difference from their plain
    versions, (rel, valid, frac) of the sharded step on the host)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from vslam_tpu_torch.alignment import fused_solve
    from vslam_tpu_torch.core.camera import Camera
    from vslam_tpu_torch.odometry.sequential import _upload
    from vslam_tpu_torch.parallel import batched, multihost, sequences
    from vslam_tpu_torch.parallel import mesh as mesh_lib

    ekf0, dts, cfg_huber, (ekf1, rel_t, valid_t) = track
    with tempfile.TemporaryDirectory() as d:
        dev = multihost.initialize(f"file://{d}/store", 1, 0)
        try:
            if dist.get_backend() != "nccl" or dev != torch.device("cuda", 0):
                raise AssertionError(f"phase 28 (a): a group of {dist.get_backend()} on {dev}")
            mesh = batched.make_mesh()
            step = batched.sharded_tracking_step(mesh, cfg_huber)
            args = batched.shard_batch((ekf0, frames["ref"], frames["cur"], dts), mesh)
            robust_inputs = {}
            _reset_launches()
            with _tap(fused_solve, "solve_level_fused", _capture_levels(robust_inputs)):
                ekf_s, rel_s, valid_s, frac = step(*args)
            _sync()
            launches_track = _launches()
            diff = _max_abs_diff((*ekf_s.pose, ekf_s.velocity, ekf_s.P, rel_s.R, rel_s.t, valid_s),
                                 (*ekf1.pose, ekf1.velocity, ekf1.P, rel_t.R, rel_t.t, valid_t))
            mean_valid = float(valid_t.float().mean())
            log(f"phase 28 (a) sharded_tracking_step in an NCCL group of one (mesh {mesh.mesh.tolist()}, "
                f"{dist.get_backend()}): B={B} {H}x{W}, Huber; launches (quadratic, robust) {launches_track}; ekf, "
                f"rel and valid against phase 6's tracking_step: max abs difference {diff:.3e}; frac {float(frac)} "
                f"(valid's mean {mean_valid})")
            if launches_track != (0, N_LEVELS) or diff != 0.0 or float(frac) != mean_valid:
                raise AssertionError(f"phase 28 (a): launches {launches_track}, difference {diff} or frac "
                                     f"{float(frac)} off")

            cfg = _odometry_cfg("odometry")
            camera = Camera.create(FX, FX, (W - 1) / 2, (H - 1) / 2)
            odo = sequences.MultiSequenceOdometry([camera] * SUITE_S, cfg, chunk=SUITE_CHUNK, mesh=batched.make_mesh())
            quad_inputs = {}
            _reset_launches()
            with _tap(fused_solve, "solve_level_fused", _capture_levels(quad_inputs)):
                res = odo.run([iter(s) for s in suite_streams])
            _sync()
            launches_run, fracs = _launches(), list(odo.fracs)
            _frame_builds("28")
            firsts, chunks = odo.stage_streams([iter(s) for s in suite_streams])
            _reset_launches()
            res_staged = odo.run_staged(firsts, chunks)
            _sync()
            launches_staged = _launches()
            _frame_builds("28")
            gaps = [_trajectory_gap(r, suite_run) for r in (res, res_staged)]
            n_steps = SUITE_FRAMES - 1
            log(f"phase 28 (a) MultiSequenceOdometry(mesh=make_mesh()) S={SUITE_S} x {SUITE_FRAMES} frames: "
                f"launches run {launches_run}, run_staged {launches_staged} (expected ({3 * n_steps}, 0) each); "
                f"against phase 21's run: gap {gaps[0][0]:.3e} / {gaps[1][0]:.3e}, bit-equal {gaps[0][1]} / "
                f"{gaps[1][1]}; the chunks' global valid fractions {fracs}")
            if not (launches_run == launches_staged == (3 * n_steps, 0) and gaps[0][1] and gaps[1][1]):
                raise AssertionError(f"phase 28 (a) suite: launches {launches_run} / {launches_staged} or poses off")

            def first_states():
                return sequences.init_states(_upload(np.stack([f[1] for f in firsts]), dev),
                                             _upload(np.stack([f[2] for f in firsts]), dev), odo.cameras, cfg)

            c = chunks[0]
            want = sequences.scan_sequences(first_states(), c.intensity, c.depth, c.dts, c.live, odo.cameras, cfg)
            states0 = first_states()
            _reset_launches()
            got = sequences.sharded_scan_sequences(mesh, cfg)(states0, c.intensity, c.depth, c.dts, c.live,
                                                               odo.cameras)
            _sync()
            launches_scan = _launches()
            _frame_builds("28")
            diff_scan = _max_abs_diff((*got[1], got[2], got[3], got[4]), (*want[1], want[2], want[3], want[4]))
            K = c.intensity.shape[1]
            log(f"phase 28 (a) sharded_scan_sequences on one chunk (S={SUITE_S}, K={K}): launches {launches_scan}, "
                f"poses, valid, cov and keyframes against scan_sequences: max abs difference {diff_scan:.3e}; frac "
                f"{float(got[5])} (valid's mean {float(want[2].float().mean())})")
            if (launches_scan != (3 * K, 0) or diff_scan != 0.0
                    or float(got[5]) != float(want[2].float().mean())):
                raise AssertionError(f"phase 28 (a) sharded_scan_sequences: launches {launches_scan}, difference "
                                     f"{diff_scan} or frac off")

            err = max(_levels_vs_plain({W: robust_inputs[W]}, "phase 28 (a) sharded_tracking_step robust", card, log),
                      _levels_vs_plain({W: quad_inputs[W]}, "phase 28 (a) suite on the mesh", card, log))

            unsharded = lambda: batched.tracking_step(ekf0, frames["ref"], frames["cur"], dts, cfg_huber)  # noqa: E731
            sharded = lambda: step(*args)  # noqa: E731
            u1, s1, s2, u2 = (_events_ms(fn, 3) for fn in (unsharded, sharded, sharded, unsharded))
            counts = torch.zeros(2, device=dev)
            mesh_lib.all_reduce_sum(counts, mesh, ("data",))
            _sync()
            t0 = time.perf_counter()
            for _ in range(100):
                mesh_lib.all_reduce_sum(counts, mesh, ("data",))
            host_us = (time.perf_counter() - t0) / 100 * 1e6
            _sync()
            t0 = time.perf_counter()
            for _ in range(100):
                mesh_lib.all_reduce_sum(counts, mesh, ("data",))
                _sync()
            synced_us = (time.perf_counter() - t0) / 100 * 1e6
            log(f"phase 28 (a) sharded_tracking_step {B / min(s1, s2) * 1e3:.1f} pairs/s against tracking_step's "
                f"{B / min(u1, u2) * 1e3:.1f} (ms per call of {B} pairs, runs unsharded, sharded, sharded, unsharded: "
                f"{u1:.3f}, {s1:.3f}, {s2:.3f}, {u2:.3f}); the counts' all_reduce (clone + NCCL all_reduce of 2 f32): "
                f"{host_us:.1f} us of host time a call, {synced_us:.1f} us a call with a synchronize after each "
                f"(mean of 100) {card}")
        finally:
            dist.destroy_process_group()
    launches = (launches_run[0] + launches_staged[0] + launches_scan[0], launches_track[1])
    ref = (rel_s.R.cpu().numpy(), rel_s.t.cpu().numpy(), valid_s.cpu().numpy(), float(frac))
    return launches, err, ref


def _mesh_rank(rank, world, tmp) -> int:
    """Phase 28 (b), one rank: a process on cuda:0 in a gloo group of
    ``world`` (NCCL refuses two ranks on one card). Renders its own block of
    the 64 pairs; runs sharded_tracking_step, sharded_tracking_step_2d on a
    (world, 1) mesh and MultiSequenceOdometry(mesh=) on phase 21's four
    streams, made lazily (a rank renders its own two); writes what it got
    to ``tmp``/out{rank}.pkl."""
    import dataclasses
    import datetime
    import pickle

    import torch
    import torch.distributed as dist

    from vslam_tpu_torch.core import se3
    from vslam_tpu_torch.core.camera import Camera
    from vslam_tpu_torch.kalman import ekf_se3
    from vslam_tpu_torch.parallel import batched, multihost, sequences
    from vslam_tpu_torch.solvers import LossConfig

    rank, world = int(rank), int(world)
    dev = multihost.initialize(f"file://{tmp}/store", world, rank, local_device_ids=[0], backend="gloo",
                               timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    out = {"device": str(dev), "backend": dist.get_backend()}
    try:
        mesh = batched.make_mesh()
        n = B // world
        frames, _ = _render_pairs(dev, range(rank * n, (rank + 1) * n), names=("ref", "cur"))
        cfg = dataclasses.replace(_production_cfg(), loss=LossConfig("Huber"))
        ekf0 = ekf_se3.init(pose=se3.identity((B,), device=dev))
        dts = torch.full((B,), 1.0 / 30.0, device=dev)
        ekf_b, dt_b = batched.shard_batch((ekf0, dts), mesh)
        step = batched.sharded_tracking_step(mesh, cfg)
        _reset_launches()
        _, rel, valid, frac = step(ekf_b, frames["ref"], frames["cur"], dt_b)
        _sync()
        out.update(track_launches=_launches(), rel=(rel.R.cpu().numpy(), rel.t.cpu().numpy()),
                   valid=valid.cpu().numpy(), frac=float(frac))
        dist.barrier()
        out["track_s"] = _walls(lambda: step(ekf_b, frames["ref"], frames["cur"], dt_b), 3)

        mesh2 = multihost.dcn_ici_mesh(n_hosts=world)
        ekf_2, dt_2 = multihost.shard_batch_2d((ekf0, dts), mesh2)
        ref_2, cur_2 = multihost.host_local_to_global((frames["ref"], frames["cur"]), mesh2)
        _reset_launches()
        _, rel2, valid2, frac2 = multihost.sharded_tracking_step_2d(mesh2, cfg)(ekf_2, ref_2, cur_2, dt_2)
        _sync()
        out.update(track2d_launches=_launches(), mesh2=mesh2.mesh.tolist(),
                   rel2d=(rel2.R.cpu().numpy(), rel2.t.cpu().numpy()), valid2d=valid2.cpu().numpy(),
                   frac2d=float(frac2))

        poses, rendered = _suite_poses(), {}

        def sequence(s):
            if s not in rendered:
                rendered[s] = _suite_sequence(s, poses)
            return rendered[s]

        streams = lambda: [_lazy_stream(lambda s=s: sequence(s)) for s in range(SUITE_S)]  # noqa: E731
        camera = Camera.create(FX, FX, (W - 1) / 2, (H - 1) / 2)
        odo = sequences.MultiSequenceOdometry([camera] * SUITE_S, _odometry_cfg("odometry"), chunk=SUITE_CHUNK,
                                              mesh=mesh)
        _reset_launches()
        out["run"] = odo.run(streams())
        _sync()
        out["run_launches"], out["fracs"] = _launches(), list(odo.fracs)
        firsts, chunks = odo.stage_streams(streams())
        _reset_launches()
        out["run_staged"] = odo.run_staged(firsts, chunks)
        _sync()
        out["staged_launches"], out["rendered"] = _launches(), sorted(rendered)
        dist.barrier()
        out["staged_s"] = _walls(lambda: odo.run_staged(firsts, chunks), 2)
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/out{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    return 0


def _mesh_ranks(ref, suite_run, card, log):
    """Phase 28 (b): MESH_RANKS processes sharing the card (`_mesh_rank`),
    each within MESH_POSE_TOL of (a)'s pairs (``ref``: rel R, t, valid,
    frac) and of phase 21's run. A rank that fails or outlasts
    MESH_TIMEOUT_S fails the phase."""
    import os
    import pickle
    import tempfile
    from pathlib import Path

    from vslam_tpu_torch.core import lie_np

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [str(root), os.environ.get("PYTHONPATH")])))
    code = "import sys, chip_smoke; sys.exit(chip_smoke._mesh_rank(*sys.argv[1:]))"
    with tempfile.TemporaryDirectory() as d:
        logs = [Path(d, f"rank{r}.log") for r in range(MESH_RANKS)]
        procs = []
        for r in range(MESH_RANKS):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen([sys.executable, "-c", code, str(r), str(MESH_RANKS), d], cwd=root,
                                              env=env, stdout=f, stderr=subprocess.STDOUT))
        t0 = time.perf_counter()
        try:
            while any(p.poll() is None for p in procs) and not any(p.returncode for p in procs):
                if time.perf_counter() - t0 > MESH_TIMEOUT_S:
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        codes = [p.returncode for p in procs]
        if any(codes):
            for r in range(MESH_RANKS):
                log(f"phase 28 (b) rank {r} exited with {codes[r]}:\n{logs[r].read_text()[-3000:]}")
            raise AssertionError(f"phase 28 (b): ranks exited with {codes} after {wall:.1f} s")
        outs = [pickle.loads(Path(d, f"out{r}.pkl").read_bytes()) for r in range(MESH_RANKS)]

    n = B // MESH_RANKS
    n_steps = SUITE_FRAMES - 1
    failures = []
    gap_pairs, same_pairs, gap_suite, same_suite = 0.0, True, 0.0, True
    for r, o in enumerate(outs):
        block = slice(r * n, (r + 1) * n)
        for key in ("rel", "rel2d"):
            R, t = o[key]
            gap_pairs = max(gap_pairs, max(float(np.linalg.norm(lie_np.log(lie_np.relative(
                _se3_matrix(R[i], t[i]), _se3_matrix(ref[0][block][i], ref[1][block][i]))))) for i in range(n)))
            same_pairs = same_pairs and np.array_equal(R, ref[0][block]) and np.array_equal(t, ref[1][block])
        for key in ("run", "run_staged"):
            g, same = _trajectory_gap(o[key], suite_run)
            gap_suite, same_suite = max(gap_suite, g), same_suite and same
        expected = {"track_launches": (0, N_LEVELS), "track2d_launches": (0, N_LEVELS),
                    "run_launches": (3 * n_steps, 0), "staged_launches": (3 * n_steps, 0)}
        counts = {k: o[k] for k in expected}
        log(f"phase 28 (b) rank {r} of {MESH_RANKS} ({o['backend']} on {o['device']}, pairs {block.start}-"
            f"{block.stop - 1}, the (host, data) mesh {o['mesh2']}): launches (quadratic, robust) {counts}; frac "
            f"{o['frac']} / {o['frac2d']} (1-D / 2-D); rendered suite sequences {o['rendered']}; the chunks' "
            f"global valid fractions {o['fracs']}")
        if counts != expected:
            failures.append(f"rank {r} launches {counts}")
        if not (o["frac"] == o["frac2d"] == ref[3]):
            failures.append(f"rank {r} frac {o['frac']} / {o['frac2d']} against {ref[3]}")
        if not (np.array_equal(o["valid"], ref[2][block]) and np.array_equal(o["valid2d"], ref[2][block])):
            failures.append(f"rank {r} valid")
        if o["rendered"] != list(range(r * SUITE_S // MESH_RANKS, (r + 1) * SUITE_S // MESH_RANKS)):
            failures.append(f"rank {r} rendered sequences {o['rendered']}")
    log(f"phase 28 (b) against (a): pairs max SE(3) gap {gap_pairs:.3e} (gate {MESH_POSE_TOL}), bit-equal "
        f"{same_pairs}; suite poses max gap {gap_suite:.3e} (gate {MESH_POSE_TOL}), bit-equal {same_suite}")
    pairs_s = B / max(min(o["track_s"]) for o in outs)
    frames_s = SUITE_S * SUITE_FRAMES / max(min(o["staged_s"]) for o in outs)
    log(f"phase 28 (b) aggregate over {MESH_RANKS} ranks sharing one card (not a scaling measurement: the ranks "
        f"share the card and the host): sharded_tracking_step {pairs_s:.1f} pairs/s (per rank best of "
        f"{', '.join(', '.join(f'{w:.3f}' for w in o['track_s']) for o in outs)} s), the suite run_staged "
        f"{frames_s:.2f} frames/s (per rank best of "
        f"{', '.join(', '.join(f'{w:.3f}' for w in o['staged_s']) for o in outs)} s); the ranks' wall {wall:.1f} s, "
        f"start-up included {card}")
    if failures or not (gap_pairs <= MESH_POSE_TOL and gap_suite <= MESH_POSE_TOL):
        raise AssertionError(f"phase 28 (b): {failures}, pair gap {gap_pairs}, pose gap {gap_suite}")


# phase 29: the port's examples
EXAMPLE_SIZES = ("100", "300")  # loop_closure_scaling's database sizes
EXAMPLE_FRAMES = 300  # dataset_analysis's trajectory


def _example(name):
    """The port's example ``examples/<name>_torch.py`` as a module."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _printed(main, argv) -> str:
    """What ``main(argv)`` prints."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _fourth_places(text: str) -> list:
    """The printed numbers in units of the 4th decimal."""
    return [round(float(x) * 1e4) for x in re.findall(r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?", text)]


def _examples(card, log):
    """Phase 29: each example's main on the card and with --device cpu;
    the printed numbers agree to one unit of their 4th decimal, the loop
    closure's answers exactly."""
    import tempfile

    from vslam_tpu_torch.core import lie_np
    from vslam_tpu_torch.io import synthetic, tum

    _reset_launches()
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/groundtruth.txt"
        poses = synthetic.smooth_trajectory(EXAMPLE_FRAMES)
        tum.write_trajectory(path, {i / 30.0: lie_np.inv(p) for i, p in enumerate(poses)})
        text = _printed(_example("dataset_analysis").main, [path])
    lines = text.splitlines()
    log(f"phase 29 dataset_analysis on {EXAMPLE_FRAMES} poses: {' | '.join(lines)}")
    if len(lines) != 5 or not lines[0].startswith(f"frames: {EXAMPLE_FRAMES} "):
        raise AssertionError(f"phase 29 dataset_analysis printed {lines}")
    failures = []
    for name in ("robust_line_fit", "ekf_motion_analysis", "epipolar_lines"):
        main = _example(name).main
        t0 = time.perf_counter()
        on_card = _printed(main, ["--device", "cuda:0"])
        ms_card = 1e3 * (time.perf_counter() - t0)
        on_cpu = _printed(main, ["--device", "cpu"])
        a, b = _fourth_places(on_card), _fourth_places(on_cpu)
        agree = len(a) == len(b) > 0 and all(abs(x - y) <= 1 for x, y in zip(a, b))
        log(f"phase 29 {name}: card {' | '.join(on_card.splitlines())} ({ms_card:.1f} ms) {card}; cpu "
            f"{' | '.join(on_cpu.splitlines())}; agree to the 4th decimal {agree}")
        if not agree:
            failures.append(name)
    main = _example("loop_closure_scaling").main
    on_card = _printed(main, [*EXAMPLE_SIZES, "--device", "cuda:0"]).splitlines()
    on_cpu = _printed(main, [*EXAMPLE_SIZES, "--device", "cpu"]).splitlines()
    for row in on_card:
        log(f"phase 29 loop_closure_scaling on the card: {row} {card}")
    answers = [[r.split()[0], *r.split()[3:]] for r in on_card[1:]]  # size, shortlist's, full scan's
    if answers != [[r.split()[0], *r.split()[3:]] for r in on_cpu[1:]] or [a[0] for a in answers] != [*EXAMPLE_SIZES]:
        failures.append(f"loop_closure_scaling: card {on_card[1:]}, cpu {on_cpu[1:]}")
    launches = (*_launches(), *(getattr(k.module, k.counter) for k in _new_kernels().values()))
    log(f"phase 29 kernel launches (quadratic, robust, sample, NE, mxu): {launches}; the examples run no aligner")
    if failures:
        raise AssertionError(f"phase 29: the card and the CPU disagree: {failures}")


# phase 30: the port's bench as a user runs it. Phases 24-25 drive the
# slam_drift and kitti_loop paths, and phases 21, 17 and 20 the suite, the
# pipeline and KITTI: those sub-benches are switched off by their own
# variables to keep the phase near BENCH_LIMIT_S (the whole line took
# 211-251 s on the H100, 38-42 s of it each loop gate and 18-24 s each of
# the other three; PERF.md, PR 16).
BENCH_OFF = ("BENCH_SLAM_DRIFT", "BENCH_KITTI_LOOP", "BENCH_MULTISEQ", "BENCH_HOST", "BENCH_KITTI")
BENCH_LIMIT_S = 150  # the phase's target, logged beside its time
BENCH_TIMEOUT_S = 400  # the subprocess's wall limit
# the keys each sub-bench adds to the line when its gates pass
BENCH_KEYS = {
    None: ("metric", "value", "unit", "vs_baseline", "methodology", "device", "link_rtt_ms", "link_up_mbytes_per_s"),
    "BENCH_ODOMETRY": ("odometry_fps", "odometry_stream_fps", "odometry_ate_m", "odometry_fps_vs_realtime_30hz"),
    "BENCH_SLAM_DRIFT": ("slam_drift_odo_ate_m", "slam_drift_ate_m", "slam_drift_online_ate_m",
                         "slam_drift_closures", "slam_drift_win"),
    "BENCH_SLAM": ("slam_fps", "slam_stream_fps", "slam_ate_m", "slam_mapping_off_ate_m", "slam_fps_vs_realtime_30hz"),
    "BENCH_MULTISEQ": ("multiseq_fps", "multiseq_stream_fps", "multiseq_seqs", "multiseq_max_ate_m"),
    "BENCH_KITTI": ("kitti_fps", "kitti_stream_fps", "kitti_ate_m", "kitti_fps_vs_realtime_10hz"),
    "BENCH_KITTI_LOOP": ("kitti_loop_odo_ate_m", "kitti_loop_ate_m", "kitti_loop_online_ate_m",
                         "kitti_loop_closures", "kitti_loop_frames", "kitti_loop_win"),
    "BENCH_HOST": ("host_fps", "host_ate_m", "host_fps_vs_10fps"),
}


def _bench(pairs, smi, card, log):
    """Phase 30: the host's waits for the card inside one headline call and
    inside `honest_loop` (2 reps) at phase 5's pairs, then `python -m
    vslam_tpu_torch.bench` in a subprocess with BENCH_OFF switched off:
    exit 0 within BENCH_TIMEOUT_S, the expected keys and no other, no rate
    of 0.0 (a failed gate), the card named as nvidia-smi names it, the
    whole-level kernel launched; its time logged beside BENCH_LIMIT_S.
    Returns the subprocess's launches of each kernel."""
    import os
    from pathlib import Path

    import torch

    from vslam_tpu_torch import bench
    from vslam_tpu_torch.parallel.batched import align_pairs

    ref, cur, rel0, x_pred, xis, cfg = pairs
    _, waits_call = _host_waits(lambda: align_pairs(ref, cur, rel0, x_pred, cfg))
    _, waits_loop = _host_waits(lambda: bench.honest_loop(bench.PairBatch(ref, cur, rel0, x_pred, xis), cfg, 2))
    _sync()
    log(f"phase 30 host waits for the card (torch's sync debug mode): {waits_call} in one align_pairs call of "
        f"{len(xis)} pairs, {waits_loop} in honest_loop's 2 reps {card}")

    torch.cuda.empty_cache()
    env = dict(os.environ, **{switch: "0" for switch in BENCH_OFF})
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "vslam_tpu_torch.bench"], cwd=Path(__file__).resolve().parent,
                         env=env, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for line in out.stderr.splitlines():
        if "took" in line or "gate" in line or "headline" in line or "FAILED" in line or "SKIPPED" in line:
            log(f"phase 30 bench: {line}")
    if out.returncode != 0 or not out.stdout.strip():
        raise AssertionError(f"phase 30: the bench exited {out.returncode}; stdout {out.stdout[-2000:]!r}; "
                             f"stderr {out.stderr[-4000:]}")
    result = json.loads(out.stdout.splitlines()[-1])
    counts = [json.loads(line.split("kernel launches ", 1)[1]) for line in out.stderr.splitlines()
              if line.startswith("bench: kernel launches ")]
    launches = counts[-1] if counts else {}
    log(f"phase 30 bench line (sub-benches off: {', '.join(BENCH_OFF)}): {json.dumps(result)}")
    log(f"phase 30 bench: {wall:.1f} s in the subprocess (limit {BENCH_LIMIT_S} s), kernel launches {launches} "
        f"{card}")
    want = {k for switch, keys in BENCH_KEYS.items() if switch not in BENCH_OFF for k in keys}
    faults = []
    if set(result) != want:
        faults.append(f"keys missing {sorted(want - set(result))}, unexpected {sorted(set(result) - want)}")
    zero = [k for k in result if (k == "value" or k.endswith("_fps")) and result[k] == 0.0]
    if zero:
        faults.append(f"rates of 0.0 (failed gates): {zero}")
    if result.get("device") != smi:
        faults.append(f"device {result.get('device')!r}, the card is {smi!r}")
    if not (result.get("slam_drift_win", True) and result.get("kitti_loop_win", True)):
        faults.append("a loop gate failed")
    if launches.get("solve_level_fused", 0) <= 0:
        faults.append(f"the whole-level kernel was not launched: {launches}")
    if faults:
        raise AssertionError(f"phase 30: {'; '.join(faults)}")
    return launches


def _se3_matrix(R, t):
    """A pose's 4x4 f64 matrix, R re-orthonormalized by SVD (as the
    odometry's fetch does)."""
    T = np.eye(4)
    u, _, vt = np.linalg.svd(np.asarray(R, np.float64))
    T[:3, :3], T[:3, 3] = u @ vt, t
    return T


def result_line(kind: str) -> dict:
    """The contract's last line: the run used one device, cuda:0."""
    return {"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}}


FB_FRAMES = 512  # the suite's sequences: the frames one scan step builds
FB_REPS = 20
# the frame build's blocks an SM (its registers' cap) tried beside the
# source's own, at level 0 and above it
FB_SWEEP = ({"kFbTopBlocks": 3}, {"kFbTopBlocks": 5}, {"kFbDownBlocks": 3})
FB_ROUNDS = 4


def _frame_build(card, log, variant_libs):
    """Phase 31: the frame build kernel against its plain version at the
    suite's shapes, bit for bit, and its time beside its bound; then each
    build of FB_SWEEP against the source's, bit for bit, device ms a level
    (1, 2 and 3 levels built, in turns, the median of FB_ROUNDS). Returns
    its entry of the kernel line, but for the launches (`FRAME_BUILDS`)."""
    import torch

    from vslam_tpu_torch.core import frame_build

    g = torch.Generator(device="cuda").manual_seed(31)
    inten = torch.randint(0, 256, (FB_FRAMES, H, W), dtype=torch.uint8, device="cuda", generator=g)
    counts = torch.randint(0, 65536, (FB_FRAMES, H, W), dtype=torch.int32, device="cuda", generator=g)
    counts = torch.where(torch.rand(counts.shape, device="cuda", generator=g) < 0.3, 0, counts)
    bits = counts.to(torch.int16)  # wraps above 32767: the bits of the unsigned counts
    scale = 1.0 / 5000.0
    before = frame_build.FRAME_BUILD_LAUNCHES
    out_k = frame_build.build_pyramid(inten, bits, N_LEVELS, scale)
    out_p = frame_build.build_pyramid_plain(inten, bits, N_LEVELS, scale)
    _sync()
    launches = frame_build.FRAME_BUILD_LAUNCHES - before
    if launches != N_LEVELS:
        raise AssertionError(f"frame build launched {launches} kernels, expected {N_LEVELS}")
    err, unequal = 0.0, []
    for name, k_levels, p_levels in zip(("intensity", "depth", "dIx", "dIy"), out_k, out_p):
        for lvl, (k, p) in enumerate(zip(k_levels, p_levels)):
            p = p.contiguous()
            err = max(err, float((k - p).abs().max()))
            if not torch.equal(k.view(torch.int32), p.view(torch.int32)):
                unequal.append(f"{name}[{lvl}]")
    if unequal:
        raise AssertionError(f"frame build kernel and plain differ in {unequal}: max_abs_err {err:.3e}")
    del out_k, out_p
    run_k = lambda: frame_build.build_pyramid(inten, bits, N_LEVELS, scale)  # noqa: E731
    run_p = lambda: frame_build.build_pyramid_plain(inten, bits, N_LEVELS, scale)  # noqa: E731
    run_k()
    p1 = _events_ms(run_p, 2)
    k1 = _events_ms(run_k, FB_REPS)
    k2 = _events_ms(run_k, FB_REPS)
    p2 = _events_ms(run_p, 2)
    px = sum(h * w for h, w in frame_build.level_shapes(H, W, N_LEVELS))
    nbytes = FB_FRAMES * (3 * H * W + 16 * px)  # sensor bytes read, four f32 planes a level written
    bound = _bound(0.0, nbytes)
    ms, plain_ms = min(k1, k2), min(p1, p2)
    log(f"frame build: {FB_FRAMES} x {H}x{W} uint8 + 16-bit depth, {N_LEVELS} levels, {launches} launches a "
        f"build, bit for bit against the plain version (max_abs_err {err:.1e}); kernel {ms:.4f} ms "
        f"(events, runs plain,kernel,kernel,plain: {p1:.3f}, {k1:.4f}, {k2:.4f}, {p2:.3f}), bound "
        f"{bound[0]:.4f} ms ({nbytes / 1e9:.3f} GB at 3.35 TB/s: {100 * bound[0] / ms:.1f} % of it), plain "
        f"{plain_ms:.3f} ms {card}")
    libs = {"source": None, **{", ".join(f"{k} {x}" for k, x in v.items()):
                               variant_libs[_variant_key("frame_build", v)] for v in FB_SWEEP}}
    out_p = frame_build.build_pyramid_plain(inten, bits, N_LEVELS, scale)
    times = {name: {n: [] for n in range(1, N_LEVELS + 1)} for name in libs}
    for name, lib in libs.items():
        out_k = frame_build._launch(inten, bits, N_LEVELS, scale, lib=lib)
        if not all(torch.equal(k.view(torch.int32), p.contiguous().view(torch.int32))
                   for k_levels, p_levels in zip(out_k, out_p) for k, p in zip(k_levels, p_levels)):
            raise AssertionError(f"frame build {name} and plain differ")
    del out_k, out_p
    for rnd in range(FB_ROUNDS):
        for name in (list(libs) if rnd % 2 == 0 else list(reversed(libs))):
            for n in times[name]:
                times[name][n].append(_events_ms(
                    lambda: frame_build._launch(inten, bits, n, scale, lib=libs[name]), FB_REPS // 2))
    for name, by_n in times.items():
        med = {n: float(np.median(v)) for n, v in by_n.items()}
        split = ", ".join(f"level {n - 1} {med[n] - med.get(n - 1, 0.0):.3f}" for n in med)
        log(f"frame build sweep, {name}: {med[N_LEVELS]:.4f} ms ({split}), bit for bit {card}")
    return {"name": "frame_build", "route": "cuda", "source": "vslam_tpu_torch/csrc/frame_build.cu",
            "replaces": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's kernels need "
              "an NVIDIA GPU (there is no CPU fallback)", file=sys.stderr)
        return 2

    import dataclasses

    from vslam_tpu_torch import _build
    from vslam_tpu_torch.alignment import fused_solve, ic
    from vslam_tpu_torch.core import se3
    from vslam_tpu_torch.core.camera import Camera
    from vslam_tpu_torch.core.frame import create_frame
    from vslam_tpu_torch.core.se3 import SE3
    from vslam_tpu_torch.kalman import ekf_se3
    from vslam_tpu_torch.parallel.batched import align_pairs, tracking_step
    from vslam_tpu_torch.solvers import LossConfig

    device = torch.device("cuda", 0)
    log = lambda s: print(s, flush=True)  # noqa: E731
    t_start = time.perf_counter()

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = f"[{smi}]"
    log(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible, using cuda:0")
    _sync()

    # 2. build, with the sweep's variants
    t0 = time.perf_counter()
    variants, variant_keys = _start_variants()
    lib_paths, ptxas = _build.build(verbose=True)
    _build.library()
    variant_libs = dict(zip(variant_keys, variants.load()))
    log(f"build: nvcc {' '.join(_build.NVCC_FLAGS)}, one process per source and per sweep variant "
        f"({len(variant_keys)}), started together -> {', '.join(p.name for p in lib_paths)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    _sync()

    # 3. quadratic entry against plain
    t0 = time.perf_counter()
    frames, xis = _render_pairs(device)
    _sync()
    log(f"rendered and built {B} x 3 frames at {H}x{W} in {time.perf_counter() - t0:.1f} s")
    problems = _level0_problems(frames, xis, device)
    max_abs, failures = _kernel_vs_plain(problems, frames, log)
    _sync()
    if failures:
        raise AssertionError(f"kernel and plain disagree beyond the limits: {failures}")

    # 4. robust entry against plain
    max_abs_robust, failures = _robust_vs_plain(problems, frames, log)
    _sync()
    if failures:
        raise AssertionError(f"robust kernel and plain disagree beyond the limits: {failures}")

    # 5. main path: align_pairs
    cfg = _production_cfg()
    rel0 = SE3(torch.eye(3, device=device).expand(B, 3, 3).contiguous(),
               torch.zeros(B, 3, device=device))
    x_pred = torch.zeros(B, 6, device=device)
    _reset_launches()
    rel, cov, valid = align_pairs(frames["ref"], frames["cur"], rel0, x_pred, cfg)
    _sync()
    launches_pairs = _launches()
    if launches_pairs != (N_LEVELS, 0):
        raise AssertionError(f"align_pairs launched {launches_pairs}, expected ({N_LEVELS}, 0)")
    align_pairs(frames["ref"], frames["cur"], rel0, x_pred, cfg)
    _sync()
    if fused_solve.LAUNCHES != 2 * N_LEVELS:
        raise AssertionError(f"second call: LAUNCHES {fused_solve.LAUNCHES}, expected {2 * N_LEVELS}")
    errs = _pair_errors(rel, xis)
    mean_err = float(np.mean(errs))
    if not (np.isfinite(cov.cpu().numpy()).all() and bool(valid.all())):
        raise AssertionError("align_pairs: non-finite covariance or an invalid pair")
    log(f"main path: align_pairs B={B} {H}x{W} {N_LEVELS} levels, LAUNCHES +{launches_pairs[0]} per call; "
        f"mean per-pair SE(3) error {mean_err:.5f} (gate 0.01), max {errs.max():.5f}")
    if not mean_err < 0.01:
        raise AssertionError(f"accuracy gate failed: mean error {mean_err}")

    # 6. tracking_step, robust profile, zero-velocity filters
    cfg_huber = dataclasses.replace(cfg, loss=LossConfig("Huber"))
    ekf0 = ekf_se3.init(pose=se3.identity((B,), device=device))
    dts = torch.full((B,), 1.0 / 30.0, device=device)
    _reset_launches()
    ekf1, rel_t, valid_t = tracking_step(ekf0, frames["ref"], frames["cur"], dts, cfg_huber)
    _sync()
    launches_track = _launches()
    errs_t = _pair_errors(rel_t, xis)
    log(f"tracking_step: B={B} {H}x{W}, Huber, launches (quadratic, robust) {launches_track}; "
        f"valid {int(valid_t.sum())}/{B}; mean per-pair SE(3) error {errs_t.mean():.5f} (gate "
        f"0.01), max {errs_t.max():.5f}; filter velocity finite "
        f"{bool(torch.isfinite(ekf1.velocity).all())}")
    if launches_track != (0, N_LEVELS):
        raise AssertionError(f"tracking_step launched {launches_track}, expected (0, {N_LEVELS})")
    if not (bool(valid_t.all()) and errs_t.mean() < 0.01 and bool(torch.isfinite(ekf1.P).all())):
        raise AssertionError("tracking_step: an invalid pair, a non-finite filter or error >= 0.01")

    # 7. main path: sequential odometry, both profiles
    t0 = time.perf_counter()
    streams = _odometry_streams()
    log(f"rendered {len(streams)} x {ODO_FRAMES} frames at {H}x{W} in {time.perf_counter() - t0:.1f} s")
    camera = Camera.create(FX, FX, (W - 1) / 2, (H - 1) / 2)  # no device named: the card
    if camera.fx.device.type != "cuda":
        raise AssertionError(f"Camera.create with no device landed on {camera.fx.device}")
    launches_odo = {name: _run_profile(name, *streams[name], camera, log)[0] for name in PROFILES}

    # 8. times
    runs = [_events_ms(lambda: align_pairs(frames["ref"], frames["cur"], rel0, x_pred, cfg), 10)
            for _ in range(3)]
    ms_align = min(runs)
    log(f"align_pairs: {ms_align:.3f} ms per call of {B} pairs = {B / ms_align * 1e3:.1f} pairs/s "
        f"(3 runs of 10 calls: {', '.join(f'{r:.3f}' for r in runs)} ms) {card}")
    cur = frames["cur"]
    ms_frame = _events_ms(lambda: create_frame(cur.intensity[0], cur.depth[0], cur.cameras[0],
                                               n_levels=N_LEVELS), 10)
    inputs = _level_inputs(frames, cfg, rel0, x_pred)
    ms_k, ms_call, ms_p, ms_pre = {}, {}, {}, {}
    work = np.zeros(2)
    for level, (pre, args) in sorted(inputs.items()):
        ms_pre[level] = _events_ms(lambda: ic.precompute_level(*pre), 10)
        run_k = lambda: fused_solve.solve_level_fused(*args)  # noqa: E731
        run_p = lambda: fused_solve.solve_level_fused_plain(*args)  # noqa: E731
        out_k = run_k()
        work += _solve_work(args, out_k[1])
        err, ok = _check(out_k, run_p(), 1e-3, log,
                         f"align_pairs level {level} kernel vs plain at the main path's inputs")
        if not ok:
            raise AssertionError(f"align_pairs level {level}: kernel and plain disagree")
        max_abs = max(max_abs, err)
        p1 = _events_ms(run_p, 2)
        k1 = _events_ms(run_k, 20)
        k2 = _events_ms(run_k, 20)
        p2 = _events_ms(run_p, 2)
        ms_call[level], ms_p[level] = min(k1, k2), min(p1, p2)
        ms_k[level], seen = _kernel_device_ms(run_k, 20, "solve_level_kernel")
        log(f"level {level} ({args[2].shape[-2]}x{args[2].shape[-1]}, P={args[0].templ.shape[-1]}): "
            f"kernel {ms_k[level]:.4f} ms on the device (profiler, mean of {seen} recorded of 20 "
            f"launches), wrapper call "
            f"{ms_call[level]:.4f} ms, plain {ms_p[level]:.3f} ms (events, runs plain,kernel,kernel,"
            f"plain: {p1:.3f}, {k1:.4f}, {k2:.4f}, {p2:.3f}), precompute {ms_pre[level]:.3f} ms {card}")
    rest = ms_align - sum(ms_call.values()) - sum(ms_pre.values())
    log(f"align_pairs breakdown: precompute {sum(ms_pre.values()):.3f} ms, solve calls "
        f"{sum(ms_call.values()):.3f} ms (kernel on the device {sum(ms_k.values()):.3f} ms), rest "
        f"{rest:.3f} ms of {ms_align:.3f} ms; building the {B} current frames (outside "
        f"align_pairs) {ms_frame:.3f} ms {card}")
    bound_pairs = _bound(*work)
    profile_times = {name: _time_profile(name, streams[name][1], camera, card, log) for name in PROFILES}
    ms_k_robust, ms_p_robust, err_robust, _, bound_robust, robust_inputs = profile_times["robust"]
    max_abs = max(max_abs, profile_times["odometry"][2])
    max_abs_robust = max(max_abs_robust, err_robust)

    # 9. the per-iteration kernels against plain, finest level
    kernels = _new_kernels()
    err_new = _samplers_vs_plain(problems, frames, kernels, log)
    del problems
    _sync()

    # 10. the per-iteration path at full width
    launches_new, captured, err_path, cfgs = _per_iteration_paths(frames, xis, kernels, log)
    err_new = {k: max(e, err_path[k]) for k, e in err_new.items()}

    # 11. the visual log at full width
    samples_vlog, robust_vlog, align_vlog = _visual_log(*streams["odometry"], camera, log)
    launches_new["fused_level_sample"] += samples_vlog

    # 12. times of the new kernels and paths
    times_new = _time_samplers(kernels, captured, card, log)
    _time_paths(frames, cfgs, align_vlog, card, log)

    # 13. where an iteration of the whole-level kernel goes, both entries
    pairs_inputs = [args for _, (_, args) in sorted(inputs.items())]
    _solve_split(pairs_inputs[0], "align_pairs", card, log)
    _solve_split(robust_inputs[0], "robust profile", card, log)

    # 14. the CTA count of the whole-level kernel
    _solve_sweep({"align_pairs": pairs_inputs, "odometry profile": profile_times["odometry"][5],
                  "robust profile": robust_inputs}, variant_libs, card, log)

    # 15. kernel 4 against grid_sample in alternation, and its split
    _mxu_alternated(captured["bilinear_sample_mxu"], card, log)
    _mxu_split(captured["bilinear_sample_mxu"],
               {name: variant_libs.get(_variant_key("sample_mxu", {"kMxuStage": s})) for s, name in MXU_STAGES.items()},
               "this version", card, log)

    # 16. the NE kernel's CTA count and points in flight, the sampler's points per thread
    _residual_sweep(captured, variant_libs, card, log)
    _sync()
    for name in PROFILES:  # the long profiler windows last: no kernel timing follows them
        profile_times[name][3]()
    _sync()

    # 17. the per-frame pipeline, both schedules, and the other configurations
    t0 = time.perf_counter()
    launches_pipe, traj_pipe = _pipeline(*streams["odometry"], device, card, log)
    log(f"phase 17 took {time.perf_counter() - t0:.1f} s")

    # 18. the CLI
    t0 = time.perf_counter()
    _cli(streams["odometry"][0], traj_pipe, streams["odometry"][1], card, log)
    log(f"phase 18 took {time.perf_counter() - t0:.1f} s")

    # 19. the size repairs: the robust entry's global residual cache, the sampler's rows
    t0 = time.perf_counter()
    err_sizes = _size_repairs(frames, xis, log)
    _sync()
    log(f"phase 19 took {time.perf_counter() - t0:.1f} s")

    # 20. the KITTI stereo scan
    t0 = time.perf_counter()
    kitti_poses, kitti_stream = _kitti_stream()
    log(f"phase 20: rendered {len(kitti_stream)} stereo pairs at {KITTI_W}x{KITTI_H} in "
        f"{time.perf_counter() - t0:.1f} s")
    launches_kitti, err_kitti = _kitti(kitti_poses, kitti_stream, card, log)
    _sync()
    log(f"phase 20 took {time.perf_counter() - t0:.1f} s")

    # 21. the suite: four sequences in lock-step, and a ragged run
    t0 = time.perf_counter()
    suite_poses, suite_streams = _suite_streams()
    log(f"phase 21: rendered {SUITE_S} x {SUITE_FRAMES} frames at {H}x{W} in {time.perf_counter() - t0:.1f} s")
    launches_suite, err_suite, suite_run = _suite(suite_poses, suite_streams, card, log)
    _sync()
    log(f"phase 21 took {time.perf_counter() - t0:.1f} s")

    # 18, its second half: the CLI on KITTI roots and suites
    t0 = time.perf_counter()
    _cli_kitti_suites([streams["odometry"], streams["robust"]], kitti_poses, kitti_stream, card, log)
    log(f"phase 18 (KITTI and suites) took {time.perf_counter() - t0:.1f} s")

    # 22. the secondary aligners
    t0 = time.perf_counter()
    _secondary_aligners(*streams["odometry"], card, log)
    _sync()
    log(f"phase 22 took {time.perf_counter() - t0:.1f} s")

    # 23. full SLAM on the noisy stream
    t0 = time.perf_counter()
    slam_poses, slam_stream = _slam_stream()
    log(f"phase 23: rendered {len(slam_stream)} noisy frames at {H}x{W} in {time.perf_counter() - t0:.1f} s")
    launches_slam, err_slam, slam_streamed = _slam(slam_poses, slam_stream, card, log)
    _sync()
    log(f"phase 23 took {time.perf_counter() - t0:.1f} s")

    # 24. the drift orbit: kernel 1b on the main path
    t0 = time.perf_counter()
    drift_poses, drift_stream = _drift_stream(device)
    log(f"phase 24: rendered {len(drift_stream)} frames at {H}x{W} on the card in {time.perf_counter() - t0:.1f} s")
    launches_drift, err_drift = _slam_drift(drift_poses, drift_stream, card, log)
    del drift_stream
    _sync()
    log(f"phase 24 took {time.perf_counter() - t0:.1f} s")

    # 25. the KITTI loop
    t0 = time.perf_counter()
    loop_poses, loop_stream = _loop_stream(device)
    log(f"phase 25: rendered {len(loop_stream)} stereo pairs at {KITTI_W}x{KITTI_H} on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    launches_loop, err_loop = _kitti_loop(loop_poses, loop_stream, card, log)
    del loop_stream
    _sync()
    log(f"phase 25 took {time.perf_counter() - t0:.1f} s")

    # 26. the pose graph above the dense solve's node count
    t0 = time.perf_counter()
    _graph_at_scale(device, card, log)
    log(f"phase 26 took {time.perf_counter() - t0:.1f} s")

    # 27. the viewer, checkpoint / resume and profiling
    t0 = time.perf_counter()
    launches_viewer = _viewer_and_resume((slam_poses, slam_stream, slam_streamed), streams["odometry"],
                                         streams["robust"], device, card, log)
    _sync()
    log(f"phase 27 took {time.perf_counter() - t0:.1f} s")

    # 28. the mesh: a group of one here, then ranks sharing the card
    t0 = time.perf_counter()
    launches_mesh, err_mesh, mesh_ref = _mesh_one(frames, (ekf0, dts, cfg_huber, (ekf1, rel_t, valid_t)),
                                                  suite_streams, suite_run, card, log)
    _mesh_ranks(mesh_ref, suite_run, card, log)
    log(f"phase 28 took {time.perf_counter() - t0:.1f} s")

    # 29. the port's examples, on the card and on the CPU
    t0 = time.perf_counter()
    _examples(card, log)
    log(f"phase 29 took {time.perf_counter() - t0:.1f} s {card}")

    # 30. the port's bench, as a user runs it
    t0 = time.perf_counter()
    launches_bench = _bench((frames["ref"], frames["cur"], rel0, x_pred, xis, cfg), smi, card, log)
    log(f"phase 30 took {time.perf_counter() - t0:.1f} s {card}")

    # 31. the frame build kernel at the suite's shapes
    t0 = time.perf_counter()
    frame_build_entry = _frame_build(card, log, variant_libs)
    log(f"phase 31 took {time.perf_counter() - t0:.1f} s {card}")
    max_abs = max(max_abs, err_kitti, err_suite, err_slam, err_loop, err_mesh)
    max_abs_robust = max(max_abs_robust, err_drift, err_mesh)
    max_abs_robust = max(max_abs_robust, err_sizes["solve_level_fused_robust"])
    err_new["fused_level_sample"] = max(err_new["fused_level_sample"], err_sizes["fused_level_sample"])
    for name, n in (*launches_pipe.items(), *launches_bench.items()):
        if name in launches_new:
            launches_new[name] += n
    log(f"total {time.perf_counter() - t_start:.1f} s")

    # ms and bound_ms: one launch at each of the 3 levels, summed
    entries = [{
        "name": "solve_level_fused",
        "route": "cuda",
        "source": "vslam_tpu_torch/csrc/fused_solve.cu",
        "replaces": "vslam_tpu/alignment/fused_solve.py:533",
        "launches": launches_pairs[0] + launches_odo["odometry"] + launches_pipe["solve_level_fused"]
        + launches_kitti + launches_suite + launches_slam + launches_loop + launches_viewer + launches_mesh[0]
        + launches_bench["solve_level_fused"],
        "max_abs_err": max_abs,
        "ms": sum(ms_k.values()),
        "plain_ms": sum(ms_p.values()),
        "bound_ms": bound_pairs[0],
        "bound_by": bound_pairs[1],
        "library_ms": None,
    }, {
        "name": "solve_level_fused_robust",
        "route": "cuda",
        "source": "vslam_tpu_torch/csrc/fused_solve.cu",
        "replaces": "vslam_tpu/alignment/fused_solve.py:520",
        "launches": launches_track[1] + launches_odo["robust"] + robust_vlog
        + launches_pipe["solve_level_fused_robust"] + launches_drift + launches_mesh[1]
        + launches_bench["solve_level_fused_robust"],
        "max_abs_err": max_abs_robust,
        "ms": sum(ms_k_robust.values()),
        "plain_ms": sum(ms_p_robust.values()),
        "bound_ms": bound_robust[0],
        "bound_by": bound_robust[1],
        "library_ms": None,
    }]
    for name, k in kernels.items():
        entries.append({"name": name, "route": "cuda", "source": k.source, "replaces": k.replaces,
                        "launches": launches_new[name], "max_abs_err": err_new[name], **times_new[name]})
    FRAME_BUILDS["30"] = launches_bench.get("frame_build", 0)
    log(f"frame build launches of the counted main-path runs, by phase: {FRAME_BUILDS}")
    entries.append({**frame_build_entry, "launches": sum(FRAME_BUILDS.values())})
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps(result_line(torch.cuda.get_device_name(0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
