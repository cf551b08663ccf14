"""Drive the PyTorch / CUDA port (`vslam_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each ending in torch.cuda.synchronize():
  1. device   — requires CUDA (no CPU fallback); prints the card's name and
                power limit as nvidia-smi reports them
  2. build    — nvcc-builds the kernels from vslam_tpu_torch/csrc
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
The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}. Any failed check raises, so the
script exits non-zero and prints no result. Imports neither jax nor
vslam_tpu.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

H, W, FX = 480, 640, 525.0
B = 64
N_LEVELS = 3


def _sync():
    import torch

    torch.cuda.synchronize()


def _render_pairs(device):
    """The bench's pairs: default_scene(seed=b), motion from default_rng(0)
    (translation +-0.01, rotation +-0.005), plus each pair's half-way frame
    for the stacked (F=2) case."""
    import torch

    from vslam_tpu_torch.core import lie_np
    from vslam_tpu_torch.core.camera import Camera
    from vslam_tpu_torch.core.frame import create_frame
    from vslam_tpu_torch.io import synthetic

    K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    cam = Camera.create(FX, FX, (W - 1) / 2, (H - 1) / 2, device=device)
    rng = np.random.default_rng(0)
    imgs = {"ref": [], "mid": [], "cur": []}
    xis = []
    for b in range(B):
        scene = synthetic.default_scene(seed=b)
        xi = np.concatenate([rng.uniform(-0.01, 0.01, 3), rng.uniform(-0.005, 0.005, 3)])
        xis.append(xi)
        for name, pose in (("ref", np.eye(4)), ("mid", lie_np.exp(0.5 * xi)), ("cur", lie_np.exp(xi))):
            imgs[name].append(synthetic.render(K, pose, (H, W), scene))
    frames = {}
    for name, lst in imgs.items():
        inten = torch.as_tensor(np.stack([i for i, _ in lst]), device=device)
        depth = torch.as_tensor(np.stack([d for _, d in lst]), device=device)
        frames[name] = create_frame(inten, depth, cam, n_levels=N_LEVELS)
    return frames, np.stack(xis)


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


def _kernel_device_ms(fn, reps, kernel_name):
    """(mean device ms per launch, records seen) of the one kernel named
    ``kernel_name`` that each call of ``fn`` launches, from a torch.profiler
    (CUPTI) window over ``reps`` calls. Unlike events around the calls, this
    excludes the host time of the wrapper, which bounds small levels. The
    profiler does not always deliver every kernel record (on the card it
    has missed one or two of 20), so the mean is over the records it
    delivered, of identical launches, and at least half must arrive."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel_name in e.name]
    if not reps // 2 <= len(us) <= reps:
        raise AssertionError(f"profiler saw {len(us)} launches of {kernel_name}, expected {reps}")
    return sum(us) / 1e3 / len(us), len(us)


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
    from vslam_tpu_torch.alignment import fused_solve

    fused_solve.LAUNCHES = 0
    fused_solve.ROBUST_LAUNCHES = 0


def _launches():
    """(quadratic-entry launches, robust-entry launches) since the reset."""
    from vslam_tpu_torch.alignment import fused_solve

    return fused_solve.LAUNCHES - fused_solve.ROBUST_LAUNCHES, fused_solve.ROBUST_LAUNCHES


ODO_FRAMES = 64
DT_NS = int(1e9 / 30)
# name: (chunk, ATE gate in metres, kernel entry the profile runs)
PROFILES = {"odometry": (32, 0.01, "quadratic"), "robust": (16, 0.02, "robust")}


def _odometry_streams():
    """The two sequential profiles' 480x640 streams in the sensor dtypes
    (uint8 intensity, uint16 depth at 1/5000 m) with their ground truth:
    `bench.py:555-586` (smooth trajectory on the plane scene, re-based on
    frame 0) and `bench.py:965-986` cut to the first 64 of its 256 frames
    (orbit on the box scene, seed 4)."""
    from vslam_tpu_torch.core import lie_np
    from vslam_tpu_torch.io import synthetic

    K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)

    def encode(images):
        return [(i * DT_NS, np.clip(np.round(inten), 0, 255).astype(np.uint8),
                 np.clip(np.round(depth * 5000.0), 0, 65535).astype(np.uint16))
                for i, (inten, depth) in enumerate(images)]

    smooth = synthetic.smooth_trajectory(ODO_FRAMES, trans_amp=0.08, rot_amp=0.03)
    p0i = lie_np.inv(smooth[0])
    smooth = [p @ p0i for p in smooth]
    scene = synthetic.BoxScene(seed=4)
    orbit = synthetic.orbit_trajectory(256, radius=0.4, height=0.05, yaw=0.12)[:ODO_FRAMES]
    return {
        "odometry": (smooth, encode(synthetic.render(K, p, (H, W)) for p in smooth)),
        "robust": (orbit, encode(synthetic.render_boxes(K, p, (H, W), scene) for p in orbit)),
    }


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


def _frame_layers(odo, first, chunk, n_steps):
    """One profiled `run_staged` of ``first`` and ``chunk``, with a
    `record_function` range around each odometry step and, inside it, the
    frame build, the precompute and the alignment. Returns (per step:
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
               (ic, "precompute_frame", "precompute"), (ic, "align", "align")]
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
    version, and a function that prints the layers of a frame and the
    device-busy share under the profiler."""
    from vslam_tpu_torch.alignment import fused_solve
    from vslam_tpu_torch.odometry.sequential import SequentialOdometry, stage_stream

    chunk, _, entry = PROFILES[profile]
    cfg = _odometry_cfg(profile)
    first, chunks = stage_stream(iter(stream), chunk, camera.fx.device)
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

    # the solve inputs the main path gives the kernel: the last frame of the
    # first chunk, recorded per level
    captured = {}
    solve = fused_solve.solve_level_fused

    def record(*args):
        captured[args[2].shape[-1]] = args
        return solve(*args)

    fused_solve.solve_level_fused = record
    try:
        odo.run_staged(first, chunks[:1])
    finally:
        fused_solve.solve_level_fused = solve
    _sync()
    widths = sorted(captured, reverse=True)  # level 0 (finest) first
    pose_tol = 1e-3 if cfg.alignment.image_dtype == "bfloat16" else 1e-4
    ms_k, ms_p = {}, {}
    max_abs, failures = 0.0, []
    for level, w in enumerate(widths):
        args = captured[w]
        run_k = lambda: fused_solve.solve_level_fused(*args)  # noqa: E731
        run_p = lambda: fused_solve.solve_level_fused_plain(*args)  # noqa: E731
        err, ok = _check(run_k(), run_p(), pose_tol, log,
                         f"{profile} profile level {level} {entry} kernel vs plain at the main path's inputs")
        max_abs = max(max_abs, err)
        if not ok:
            failures.append(level)
        p1 = _events_ms(run_p, 2)
        k1 = _events_ms(run_k, 20)
        p2 = _events_ms(run_p, 2)
        ms_p[level] = min(p1, p2)
        ms_k[level], seen = _kernel_device_ms(run_k, 20, "solve_level_kernel")
        log(f"{profile} profile level {level} ({args[2].shape[-2]}x{w}, F={args[0].templ.shape[1]}, "
            f"P={args[0].templ.shape[-1]}, {entry} entry): kernel {ms_k[level]:.4f} ms on the device "
            f"(profiler, mean of {seen} recorded of 20 launches), wrapper call {k1:.4f} ms, plain {ms_p[level]:.3f} ms (events, "
            f"runs plain,kernel,plain: {p1:.3f}, {k1:.4f}, {p2:.3f}) {card}")
    if failures:
        raise AssertionError(f"{profile} profile: kernel and plain disagree at levels {failures}")
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

    return ms_k, ms_p, max_abs, layers


def result_line(kind: str) -> dict:
    """The contract's last line: the run used one device, cuda:0."""
    return {"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}}


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

    # 2. build
    t0 = time.perf_counter()
    lib_path, ptxas = _build.build(verbose=True)
    _build.library()
    log(f"build: nvcc {' '.join(_build.NVCC_FLAGS)} -> {lib_path.name} in "
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
    del problems

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
    camera = Camera.create(FX, FX, (W - 1) / 2, (H - 1) / 2, device=device)
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
    for level, (pre, args) in sorted(inputs.items()):
        ms_pre[level] = _events_ms(lambda: ic.precompute_level(*pre), 10)
        run_k = lambda: fused_solve.solve_level_fused(*args)  # noqa: E731
        run_p = lambda: fused_solve.solve_level_fused_plain(*args)  # noqa: E731
        err, ok = _check(run_k(), run_p(), 1e-3, log,
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
    profile_times = {name: _time_profile(name, streams[name][1], camera, card, log) for name in PROFILES}
    ms_k_robust, ms_p_robust, err_robust, _ = profile_times["robust"]
    max_abs = max(max_abs, profile_times["odometry"][2])
    max_abs_robust = max(max_abs_robust, err_robust)
    for name in PROFILES:  # the long profiler windows last: no kernel timing follows them
        profile_times[name][3]()
    _sync()
    log(f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "solve_level_fused",
        "route": "cuda",
        "source": "vslam_tpu_torch/csrc/fused_solve.cu",
        "replaces": "vslam_tpu/alignment/fused_solve.py:533",
        "launches": launches_pairs[0] + launches_odo["odometry"],
        "max_abs_err": max_abs,
        "ms": sum(ms_k.values()),
        "plain_ms": sum(ms_p.values()),
    }, {
        "name": "solve_level_fused_robust",
        "route": "cuda",
        "source": "vslam_tpu_torch/csrc/fused_solve.cu",
        "replaces": "vslam_tpu/alignment/fused_solve.py:520",
        "launches": launches_track[1] + launches_odo["robust"],
        "max_abs_err": max_abs_robust,
        "ms": sum(ms_k_robust.values()),
        "plain_ms": sum(ms_p_robust.values()),
    }]}), flush=True)
    print(json.dumps(result_line(torch.cuda.get_device_name(0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
