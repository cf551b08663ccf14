"""Drive the PyTorch / CUDA port (`vslam_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each ending in torch.cuda.synchronize():
  1. device  — requires CUDA (no CPU fallback); prints the card's name and
               power limit as nvidia-smi reports them
  2. build   — nvcc-builds the kernels from vslam_tpu_torch/csrc
  3. kernel  — the whole-level GN kernel against its plain PyTorch version
               on the same tensors: 64 rendered 480x640 pairs, finest level,
               four cases (F=1 nearest bf16, F=1 nearest f32, F=2 + prior
               nearest f32, F=1 bilinear f32)
  4. main    — `align_pairs` on the 64 pairs with the production profile
               (3 levels, 2048 points, nearest, bf16, prior, GN <= 100):
               one kernel launch per level, and the per-pair SE(3) error
               gate (< 0.01)
  5. times   — align_pairs pairs/s and per-level plain and wrapper-call ms
               (CUDA events after warm-up), and the kernel's own device
               time (torch.profiler)
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
    """Mean device time per call of the one kernel named ``kernel_name`` that
    each call of ``fn`` launches, from a torch.profiler (CUPTI) window over
    ``reps`` calls. Unlike events around the calls, this excludes the host
    time of the wrapper, which bounds small levels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel_name in e.name]
    if len(us) != reps:
        raise AssertionError(f"profiler saw {len(us)} launches of {kernel_name}, expected {reps}")
    return sum(us) / 1e3 / reps


def _kernel_vs_plain(frames, xis, device, log):
    """Phase 3: the kernel and the plain version on the same CUDA tensors."""
    import dataclasses

    import torch

    from vslam_tpu_torch.alignment import fused_solve, ic
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
    # F = 2: keyframe at identity and the half-way frame; prediction = the
    # half-way pose (no motion since the last frame)
    ref2 = stack_frames([frames["ref"], frames["mid"]], dim=1)
    data2 = ic.precompute_level(ref2.intensity[level], ref2.dIx[level], ref2.dIy[level],
                                ref2.depth[level], ref1.cameras[level], base.min_gradient,
                                max_points=base.max_points)
    mid_pose = se3.exp(torch.as_tensor(0.5 * xis, dtype=torch.float32, device=device))
    rel2 = SE3(torch.stack([mid_pose.R, torch.eye(3, device=device).expand(B, 3, 3)], 1),
               torch.stack([mid_pose.t, torch.zeros(B, 3, device=device)], 1))
    xp2 = se3.log(rel2)
    cases = [
        ("F=1 nearest bf16", base, data1, eye, torch.zeros(B, 1, 6, device=device), 1e-3),
        ("F=1 nearest f32", dataclasses.replace(base, image_dtype="float32"), data1, eye,
         torch.zeros(B, 1, 6, device=device), 1e-4),
        ("F=2 prior nearest f32", dataclasses.replace(base, image_dtype="float32"), data2, rel2, xp2, 1e-4),
        ("F=1 bilinear f32", dataclasses.replace(base, image_dtype="float32", interpolation="bilinear"),
         data1, eye, torch.zeros(B, 1, 6, device=device), 1e-4),
    ]
    img = frames["cur"].intensity[level]
    cam = frames["cur"].cameras[level]
    max_abs = 0.0
    failures = []
    for name, cfg, data, rel0, xp, pose_tol in cases:
        rel_k, res_k = fused_solve.solve_level_fused(data, rel0, img, cam, cfg, xp)
        rel_p, res_p = fused_solve.solve_level_fused_plain(data, rel0, img, cam, cfg, xp)
        _sync()
        valid_eq = torch.equal(res_k.valid, res_p.valid)
        it_abs = (res_k.iterations - res_p.iterations).abs()
        first = lambda r: SE3(r.R[:, 0], r.t[:, 0])  # noqa: E731
        dists = _pose_dist(first(rel_k), first(rel_p))
        scale = res_p.A.abs().amax(dim=(1, 2))
        a_rels = (res_k.A - res_p.A).abs().amax(dim=(1, 2)) / scale
        err = max((rel_k.R - rel_p.R).abs().max().item(), (rel_k.t - rel_p.t).abs().max().item())
        max_abs = max(max_abs, err)
        it_diff, dist, a_rel = it_abs.max().item(), dists.max().item(), a_rels.max().item()
        log(f"kernel vs plain [{name}]: valid equal {valid_eq} ({int(res_k.valid.sum())}/{B}), "
            f"iterations max diff {it_diff} (limit 1; mean {res_k.iterations.float().mean().item():.2f}, "
            f"pairs differing {int((it_abs > 0).sum())}), pose dist max {dist:.3e} (limit "
            f"{pose_tol:g}), A max diff {a_rel:.3e} of max|A| (limit 1e-3), pose entries max "
            f"abs diff {err:.3e}")
        ok = valid_eq and it_diff <= 1 and dist < pose_tol and a_rel < 1e-3
        if not ok:
            b = int(torch.argmax(it_abs.float() + dists / pose_tol + a_rels / 1e-3))
            n = int(max(res_k.iterations[b], res_p.iterations[b])) + 2
            log(f"  worst pair {b}: iterations kernel {int(res_k.iterations[b])} plain "
                f"{int(res_p.iterations[b])}, dist {dists[b].item():.3e}, A {a_rels[b].item():.3e}")
            for lbl, res in (("kernel", res_k), ("plain", res_p)):
                log(f"  {lbl} chi2 {res.chi2_history[b, :n].tolist()}")
                log(f"  {lbl} step {res.step_history[b, :n].tolist()}")
            failures.append(name)
    return max_abs, failures


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's kernels need "
              "an NVIDIA GPU (there is no CPU fallback)", file=sys.stderr)
        return 2

    from vslam_tpu_torch import _build
    from vslam_tpu_torch.alignment import fused_solve, ic
    from vslam_tpu_torch.core.frame import create_frame
    from vslam_tpu_torch.core.se3 import SE3
    from vslam_tpu_torch.parallel.batched import align_pairs

    device = torch.device("cuda", 0)
    log = lambda s: print(s, flush=True)  # noqa: E731

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = f"[{smi}]"
    log(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible")
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

    # 3. kernel against plain
    t0 = time.perf_counter()
    frames, xis = _render_pairs(device)
    _sync()
    log(f"rendered and built {B} x 3 frames at {H}x{W} in {time.perf_counter() - t0:.1f} s")
    max_abs, failures = _kernel_vs_plain(frames, xis, device, log)
    _sync()
    if failures:
        raise AssertionError(f"kernel and plain disagree beyond the limits: {failures}")

    # 4. main path
    cfg = _production_cfg()
    rel0 = SE3(torch.eye(3, device=device).expand(B, 3, 3).contiguous(),
               torch.zeros(B, 3, device=device))
    x_pred = torch.zeros(B, 6, device=device)
    fused_solve.LAUNCHES = 0
    rel, cov, valid = align_pairs(frames["ref"], frames["cur"], rel0, x_pred, cfg)
    _sync()
    launches = fused_solve.LAUNCHES
    if launches != N_LEVELS:
        raise AssertionError(f"main path launched the kernel {launches} times, expected {N_LEVELS}")
    align_pairs(frames["ref"], frames["cur"], rel0, x_pred, cfg)
    _sync()
    if fused_solve.LAUNCHES != 2 * N_LEVELS:
        raise AssertionError(f"second call: LAUNCHES {fused_solve.LAUNCHES}, expected {2 * N_LEVELS}")
    from vslam_tpu_torch.core import lie_np

    R_all, t_all = rel.R.double().cpu().numpy(), rel.t.double().cpu().numpy()
    errs = []
    for b in range(B):
        T = np.eye(4)
        u, _, vt = np.linalg.svd(R_all[b])
        T[:3, :3] = u @ vt
        T[:3, 3] = t_all[b]
        errs.append(np.linalg.norm(lie_np.log(T) - xis[b]))
    mean_err = float(np.mean(errs))
    if not (np.isfinite(cov.cpu().numpy()).all() and bool(valid.all())):
        raise AssertionError("align_pairs: non-finite covariance or an invalid pair")
    log(f"main path: align_pairs B={B} {H}x{W} {N_LEVELS} levels, LAUNCHES +{launches} per call; "
        f"mean per-pair SE(3) error {mean_err:.5f} (gate 0.01), max {max(errs):.5f}")
    if not mean_err < 0.01:
        raise AssertionError(f"accuracy gate failed: mean error {mean_err}")

    # 5. times
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
        run_k(), run_p()
        p1 = _events_ms(run_p, 2)
        k1 = _events_ms(run_k, 20)
        k2 = _events_ms(run_k, 20)
        p2 = _events_ms(run_p, 2)
        ms_call[level], ms_p[level] = min(k1, k2), min(p1, p2)
        ms_k[level] = _kernel_device_ms(run_k, 20, "solve_level_kernel")
        log(f"level {level} ({args[2].shape[-2]}x{args[2].shape[-1]}, P={args[0].templ.shape[-1]}): "
            f"kernel {ms_k[level]:.4f} ms on the device (profiler, mean of 20), wrapper call "
            f"{ms_call[level]:.4f} ms, plain {ms_p[level]:.3f} ms (events, runs plain,kernel,kernel,"
            f"plain: {p1:.3f}, {k1:.4f}, {k2:.4f}, {p2:.3f}), precompute {ms_pre[level]:.3f} ms {card}")
    rest = ms_align - sum(ms_call.values()) - sum(ms_pre.values())
    log(f"align_pairs breakdown: precompute {sum(ms_pre.values()):.3f} ms, solve calls "
        f"{sum(ms_call.values()):.3f} ms (kernel on the device {sum(ms_k.values()):.3f} ms), rest "
        f"{rest:.3f} ms of {ms_align:.3f} ms; building the {B} current frames (outside "
        f"align_pairs) {ms_frame:.3f} ms {card}")
    _sync()

    print(json.dumps({"kernels": [{
        "name": "solve_level_fused",
        "route": "cuda",
        "source": "vslam_tpu_torch/csrc/fused_solve.cu",
        "replaces": "vslam_tpu/alignment/fused_solve.py:533",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": sum(ms_k.values()),
        "plain_ms": sum(ms_p.values()),
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
