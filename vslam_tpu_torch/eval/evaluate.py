"""Experiment CLI — the ROS-free replacement for the reference's
`script/evaluate.py` + `launch/evaluation.launch.py` composition.

Port of `vslam_tpu.eval.evaluate`, run as

    python -m vslam_tpu_torch.eval.evaluate synthetic --frames 8 --device cpu

with the JAX CLI's subcommands, flags, JSON lines and exit codes, plus
``--device`` (default cuda) on the commands that track:

  odometry   run VO over a TUM sequence directory or a KITTI root (--format
             kitti: stereo depth by block matching on the device) -> TUM
             trajectory file (the NodeReplayer/NodeRgbdAlignment/
             NodeResultWriter pipeline in one deterministic process): the
             host pipeline, or with --fused the sequential scan; a repeated
             --dataset tracks every sequence in lock-step (suite mode)
  evaluate   ATE + RPE of an estimated trajectory vs ground truth, writing
             rpe_summary/ate_summary like the reference's script
             (script/evaluate.py:60-75)
  ate, rpe   the reference's evaluate_ate.py / evaluate_rpe.py interfaces
  synthetic  dataset-free end-to-end check on the analytic plane scene
  reproduce  replay + the reference protocols, pass/fail against the
             published fr2_desk budgets

--mapping runs the SLAM backend (features, windowed BA) on the host loop,
the sequential scan and in suite mode. --live-viz PORT serves the live
viewer (`viz.LiveViz`, GET /state.json and /): the host loop publishes per
frame, the sequential scan per retired chunk; suite mode warns and ignores
it, as the JAX CLI does.

Provenance: like the reference's meta.yaml (script/evaluate.py:51-55), the
odometry command records config + git sha next to the trajectory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time


def _cmd_odometry(args) -> int:
    import numpy as np

    from ..config import PipelineConfig, load_yaml_config
    from ..core.camera import Camera
    from ..io import tum
    from ..odometry.pipeline import OdometryPipeline
    from ..utils.log import configure, get_logger

    configure(args.log_level)
    log = get_logger("system")
    cfg = load_yaml_config(args.config) if args.config else PipelineConfig()
    if args.mapping:
        cfg = dataclasses.replace(cfg, enable_mapping=True)
    if args.live_viz is not None:
        # the reference's RViz channel (NodeMapping.cpp:231-272); the host
        # loop publishes per frame, the sequential scan per retired chunk
        cfg = dataclasses.replace(cfg, live_viz_port=args.live_viz)
    if len(args.dataset) > 1:
        if cfg.live_viz_port is not None:
            log.warning("--live-viz is not supported with multiple --dataset values (the batched "
                        "multi-sequence scan has no per-frame host loop to publish from); ignoring it")
        return _cmd_odometry_multi(args, cfg, log)
    args.dataset = args.dataset[0]
    if args.format == "kitti":
        from ..io.kitti import KittiDataset

        ds = KittiDataset(args.dataset, sequence=args.sequence, max_frames=args.max_frames,
                          device=args.device)
    else:
        ds = tum.TumDataset(args.dataset, max_frames=args.max_frames)
    if args.intrinsics:
        fx, fy, cx, cy = (float(x) for x in args.intrinsics.split(","))
    else:
        fx, fy, cx, cy = ds.intrinsics()
    camera = Camera.create(fx, fy, cx, cy, device=args.device)
    log.warning("tracking %d frames from %s", len(ds), args.dataset)

    if args.fused:
        # the sequential scan (one fetch per chunk; odometry only)
        from ..odometry.sequential import SequentialOdometry

        cfg = _production_profile(cfg, args)
        if args.format == "kitti":
            # raw u8 stereo pairs in; block-matching depth on the device
            # inside the scan step
            stream, seq_cfg = ds.iter_stereo(), _seq_config(cfg, stereo_baseline=ds.baseline)
        else:
            # native u8/u16 transport: the device converts (depth_scale);
            # the host->device link moves the sensor's own bit depth
            stream, seq_cfg = ds.iter_raw(), _seq_config(cfg, depth_scale=tum.DEPTH_SCALE)
        viz = _viewer(cfg.live_viz_port)
        odo = SequentialOdometry(camera, seq_cfg, chunk=args.chunk, mapping=_mapping_backend(cfg, args.device),
                                 viz=viz)
        t0 = time.perf_counter()
        results = odo.run(stream)
        elapsed = time.perf_counter() - t0
        n = len(results)
        est = {t / 1e9: np.linalg.inv(p) for t, p, _ in results}
        covs = {t / 1e9: c for t, _, c in results}
    else:
        from ..odometry.pipeline import device_prefetch

        pipeline = OdometryPipeline(camera, cfg, device=args.device)
        viz = pipeline.viz
        # native u8/u16 transport (KITTI: f32 left image and stereo depth in
        # metres) + device prefetch: the transfer of frame i+1 overlaps the
        # solve of frame i
        frame_iter = ds.iter_raw() if args.format == "tum" else iter(ds)
        t0 = time.perf_counter()
        n = 0
        for t_ns, intensity, depth in device_prefetch(frame_iter, device=args.device):
            pipeline.process_frame(t_ns, intensity, depth)
            n += 1
            if n % 50 == 0:
                fps = n / (time.perf_counter() - t0)
                log.warning("frame %d/%d (%.1f fps)", n, len(ds), fps)
        elapsed = time.perf_counter() - t0
        est = {t / 1e9: np.linalg.inv(p) for t, p in pipeline.trajectory.items()}
        covs = {
            t / 1e9: pipeline.trajectory.cov_at(t)
            for t, _ in pipeline.trajectory.items()
            if pipeline.trajectory.cov_at(t) is not None
        }
    # (cam->world TUM convention; inv is exact for rigid transforms)
    # Covariance columns are always appended, like NodeResultWriter
    # (NodeResultWriter.cpp:17-32 writes the 36 entries on every row).
    out = args.out or "trajectory.txt"
    tum.write_trajectory(out, est, covs=covs if covs else None)
    meta = {
        "dataset": args.dataset,
        "frames": n,
        "elapsed_s": round(elapsed, 2),
        "fps": round(n / elapsed, 2),
        "config": dataclasses.asdict(cfg),
        "git_sha": _git_sha(),
    }
    with open(out + ".meta.json", "w") as f:
        json.dump(meta, f, indent=2)
    print(json.dumps({"frames": n, "fps": meta["fps"], "trajectory": out}))

    if ds.groundtruth and not args.no_eval:
        from . import metrics

        res = metrics.summarize(ds.groundtruth, est)
        print(json.dumps(res))
    if viz is not None:
        viz.close()
    return 0


def _viewer(port):
    """A `viz.LiveViz` on ``port`` (0: an ephemeral one), or None."""
    if port is None:
        return None
    from ..viz import LiveViz

    return LiveViz(port=port)


def _mapping_backend(cfg, device):
    """The sequential scan's mapping backend where the configuration enables
    mapping or loop closure, else None."""
    if not (cfg.enable_mapping or cfg.enable_loop_closure):
        return None
    from ..odometry.sequential_mapping import ChunkMappingBackend

    return ChunkMappingBackend(enable_ba=cfg.enable_mapping, enable_loop_closure=cfg.enable_loop_closure,
                               ba_max_iterations=cfg.ba_max_iterations, pose_write_back=cfg.ba_pose_write_back,
                               device=device)


def _seq_config(cfg, stereo_baseline: float = 0.0, depth_scale: float = 1.0):
    """The sequential scan's configuration from a pipeline configuration."""
    from ..odometry.sequential import SequentialConfig

    return SequentialConfig(
        alignment=cfg.alignment_config(),
        stereo_baseline=stereo_baseline,
        depth_scale=depth_scale,
        prediction_model=cfg.prediction_model,
        n_levels=cfg.pyramid_levels,
        kf_period=cfg.keyframe_selection_idx_period,
        kf_max_translation=cfg.keyframe_selection_max_translation,
        include_key_frame=cfg.include_key_frame,
    )


def _production_profile(cfg, args):
    """The fused paths' tracking profile unless --parity or a configured
    sampler says otherwise: the whole-level GN kernel on a 2048-point
    budget from a bf16 image copy (the bench configuration). --parity keeps
    the reference's dense gather semantics."""
    if not args.parity and cfg.sampler == "gather":
        cfg = dataclasses.replace(cfg, sampler="fused_gn", image_dtype="bfloat16", features_max_points=2048)
    return cfg


def _unique_names(roots) -> list:
    """Per-sequence output names from dataset roots: the basename, with a
    .N suffix where two roots share a leaf directory name (/runA/kitti and
    /runB/kitti), so no two sequences write the same trajectory file."""
    names = [os.path.basename(os.path.normpath(r)) for r in roots]
    dup = {n for n in names if names.count(n) > 1}
    seen: dict = {}
    out = []
    for n in names:
        if n in dup:
            seen[n] = seen.get(n, 0) + 1
            out.append(f"{n}.{seen[n]}")
        else:
            out.append(n)
    return out


def _cmd_odometry_multi(args, cfg, log) -> int:
    """Suite mode: S TUM sequences or KITTI roots advanced in lock-step by
    `parallel.sequences.MultiSequenceOdometry`, one dispatch per chunk for
    every sequence (the reference's driver loops sequences one after the
    other, script/evaluate.py). The fused path only; per-sequence
    intrinsics are kept. Exit 2 when KITTI roots disagree on the stereo
    baseline (one configuration serves all sequences)."""
    import numpy as np

    from ..core.camera import Camera
    from ..io import tum
    from ..parallel.sequences import MultiSequenceOdometry

    if not args.fused:
        log.warning("multiple --dataset implies --fused (the batched scan)")
    cfg = _production_profile(cfg, args)
    if args.format == "kitti":
        # each --dataset is a KITTI root; --sequence applies to all
        from ..io.kitti import KittiDataset

        datasets = [KittiDataset(d, sequence=args.sequence, max_frames=args.max_frames, device=args.device)
                    for d in args.dataset]
        baselines = {round(ds.baseline, 6) for ds in datasets}
        if len(baselines) > 1:
            print(f"KITTI suite needs one shared stereo baseline, got {baselines} (one "
                  "configuration serves every sequence of the batched scan)", file=sys.stderr)
            return 2
        seq_cfg = _seq_config(cfg, stereo_baseline=datasets[0].baseline)
        streams = [ds.iter_stereo() for ds in datasets]
    else:
        datasets = [tum.TumDataset(d, max_frames=args.max_frames) for d in args.dataset]
        seq_cfg = _seq_config(cfg, depth_scale=tum.DEPTH_SCALE)
        streams = [ds.iter_raw() for ds in datasets]
    if args.intrinsics:
        intrinsics = [tuple(float(x) for x in args.intrinsics.split(","))] * len(datasets)
    else:
        intrinsics = [ds.intrinsics() for ds in datasets]
    cameras = [Camera.create(*k, device=args.device) for k in intrinsics]
    mappings = None
    if cfg.enable_mapping or cfg.enable_loop_closure:
        mappings = [_mapping_backend(cfg, args.device) for _ in datasets]
    odo = MultiSequenceOdometry(cameras, seq_cfg, chunk=args.chunk, mappings=mappings)
    log.warning("tracking %d sequences (%s frames) in lock-step", len(datasets),
                "/".join(str(len(d)) for d in datasets))
    t0 = time.perf_counter()
    all_results = odo.run(streams)
    elapsed = time.perf_counter() - t0
    n_total = sum(len(r) for r in all_results)

    out_prefix = (args.out or "trajectory.txt").removesuffix(".txt")
    summary = {
        "sequences": len(datasets),
        "frames": n_total,
        "fps": round(n_total / elapsed, 2),
        "git_sha": _git_sha(),
    }
    per_seq = []
    for name, ds, results in zip(_unique_names([ds.root for ds in datasets]), datasets, all_results):
        est = {t / 1e9: np.linalg.inv(p) for t, p, _ in results}
        covs = {t / 1e9: c for t, _, c in results}
        out = f"{out_prefix}_{name}.txt"
        tum.write_trajectory(out, est, covs=covs)
        entry = {"dataset": name, "frames": len(results), "trajectory": out}
        if ds.groundtruth and not args.no_eval:
            from . import metrics

            try:
                entry.update(metrics.summarize(ds.groundtruth, est))
            except ValueError as exc:
                # a sequence too short for any RPE pair: record it per
                # sequence instead of losing the whole summary
                entry["eval_error"] = str(exc)
        per_seq.append(entry)
    summary["results"] = per_seq
    with open(out_prefix + "_suite.meta.json", "w") as f:
        json.dump({**summary, "config": dataclasses.asdict(cfg)}, f, indent=2)
    print(json.dumps(summary))
    return 0


def _cmd_evaluate(args) -> int:
    from ..io import tum
    from . import metrics

    gt = tum.read_trajectory(args.gt)
    est = tum.read_trajectory(args.algo)
    ate, n_ate = metrics.ate_rmse(gt, est, max_difference=args.max_difference)
    rpe_t, rpe_r, n_rpe = metrics.rpe(
        gt, est, fixed_delta=args.fixed_delta, max_difference=args.max_difference
    )
    out_dir = os.path.dirname(os.path.abspath(args.algo))
    if args.plot:
        from . import plot

        plot.plot_trajectory(gt, est, os.path.join(out_dir, "traj.png"))
        plot.plot_rpe(gt, est, os.path.join(out_dir, "rpe.png"), fixed_delta=args.fixed_delta)
    with open(os.path.join(out_dir, "ate_summary.txt"), "w") as f:
        f.write(f"absolute_translational_error.rmse {ate:.6f} m (pairs: {n_ate})\n")
    with open(os.path.join(out_dir, "rpe_summary.txt"), "w") as f:
        f.write(
            f"translational_error.rmse {rpe_t:.6f} m\n"
            f"rotational_error.rmse {rpe_r:.6f} rad\n"
            f"pairs {n_rpe}\n"
        )
    print(
        json.dumps(
            {
                "ate_rmse_m": ate,
                "rpe_trans_rmse_m": rpe_t,
                "rpe_rot_rmse_rad": rpe_r,
                "n_ate": n_ate,
                "n_rpe": n_rpe,
            }
        )
    )
    return 0


def _cmd_ate(args) -> int:
    """`vslam-run ate` — the reference's evaluate_ate.py interface,
    option-for-option (`script/vslam_evaluation/tum/evaluate_ate.py:116-162`):
    prints the bare RMSE by default, the full statistics block with
    --verbose, and writes the --save / --save-associations files in the
    script's exact formats."""
    import numpy as np

    from ..io import tum
    from . import metrics

    gt = tum.read_trajectory(args.gt)
    est = tum.read_trajectory(args.algo)
    try:
        stats, assoc, full = metrics.evaluate_ate_full(
            gt, est, offset=args.offset, scale=args.scale,
            max_difference=args.max_difference,
        )
    except ValueError as exc:
        print(str(exc), file=sys.stderr)
        return 1
    if args.save:
        np.savetxt(args.save, full, fmt="%f")
    if args.save_associations:
        np.savetxt(args.save_associations, assoc, fmt="%f")
    if args.plot:
        from . import plot

        plot.plot_trajectory(gt, est, args.plot)
    if args.verbose:
        print("compared_pose_pairs %d pairs" % stats["compared_pose_pairs"])
        for key, val in stats.items():
            if key != "compared_pose_pairs":
                print("%s %f m" % (key, val))
    else:
        print("%f" % stats["absolute_translational_error.rmse"])
    return 0


def _cmd_rpe(args) -> int:
    """`vslam-run rpe` — the reference's evaluate_rpe.py interface,
    option-for-option (`script/vslam_evaluation/tum/evaluate_rpe.py:298-367`):
    delta units s/m/rad/deg/f, fixed-delta or sampled all-pairs, offset,
    scale, --save per-pair dump, --verbose statistics block (translational
    in m, rotational in deg; the bare default prints the trans RMSE)."""
    import numpy as np

    from ..io import tum
    from . import metrics

    gt = tum.read_trajectory(args.gt)
    est = tum.read_trajectory(args.algo)
    try:
        rows = metrics.evaluate_rpe_full(
            gt, est, max_pairs=args.max_pairs, fixed_delta=args.fixed_delta,
            delta=args.delta, delta_unit=args.delta_unit, offset=args.offset,
            scale=args.scale,
        )
    except ValueError as exc:
        print(str(exc), file=sys.stderr)
        return 1
    if args.save:
        np.savetxt(args.save, rows, fmt="%f")
    stats = metrics.rpe_stats(rows)
    if args.verbose:
        print("compared_pose_pairs %d pairs" % stats["compared_pose_pairs"])
        for key, val in stats.items():
            if key == "compared_pose_pairs":
                continue
            unit = "m" if key.startswith("translational") else "deg"
            print("%s %f %s" % (key, val, unit))
    else:
        # the reference's bare output is the MEAN translational error
        # (evaluate_rpe.py:367), not the RMSE — kept for parity
        print("%f" % stats["translational_error.mean"])
    return 0


def _cmd_synthetic(args) -> int:
    import numpy as np

    from ..config import PipelineConfig
    from ..core import lie_np
    from ..core.camera import Camera
    from ..io import synthetic
    from ..odometry.pipeline import OdometryPipeline
    from . import metrics

    H, W, FX = args.height, args.width, args.fx
    K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    poses = synthetic.smooth_trajectory(args.frames, trans_amp=0.08, rot_amp=0.03)
    p0i = lie_np.inv(poses[0])
    poses = [p @ p0i for p in poses]
    dt_ns = int(1e9 / 30)

    cfg = PipelineConfig(
        features_min_gradient=10.0,
        solver_max_iterations=50,
        solver_min_step_size=1e-7,
        enable_mapping=args.mapping,
        live_viz_port=args.live_viz,
    )
    camera = Camera.create(FX, FX, (W - 1) / 2, (H - 1) / 2, device=args.device)
    if args.realistic:
        # occlusion scene + Kinect-like sensor degradation: the strongest
        # dataset-free accuracy proxy (exact pose GT, realistic nuisances)
        sensor = synthetic.SensorModel()
        frames = [
            synthetic.degrade(*synthetic.render_boxes(K, p, (H, W)), sensor, i)
            for i, p in enumerate(poses)
        ]
    else:
        frames = [synthetic.render(K, p, (H, W)) for p in poses]
    n_landmarks = 0
    if args.fused:
        from ..odometry.sequential import SequentialConfig, SequentialOdometry

        mapping = None
        if args.mapping:
            from ..odometry.sequential_mapping import ChunkMappingBackend

            mapping = ChunkMappingBackend(enable_ba=True, device=args.device)
        viz = _viewer(cfg.live_viz_port)
        odo = SequentialOdometry(
            camera,
            SequentialConfig(alignment=cfg.alignment_config(), n_levels=cfg.pyramid_levels),
            chunk=8,
            mapping=mapping,
            viz=viz,
        )
        t0 = time.perf_counter()
        results = odo.run((i * dt_ns, f[0], f[1]) for i, f in enumerate(frames))
        elapsed = time.perf_counter() - t0
        est = {t / 1e9: lie_np.inv(p) for t, p, _ in results}
        if mapping is not None:
            n_landmarks = mapping.n_landmarks
    else:
        pipeline = OdometryPipeline(camera, cfg, device=args.device)
        viz = pipeline.viz
        t0 = time.perf_counter()
        for i, (intensity, depth) in enumerate(frames):
            pipeline.process_frame(i * dt_ns, intensity, depth)
        elapsed = time.perf_counter() - t0
        est = {t / 1e9: lie_np.inv(p) for t, p in pipeline.trajectory.items()}
        n_landmarks = len(pipeline.map.points())

    gt = {i * dt_ns / 1e9: lie_np.inv(p) for i, p in enumerate(poses)}
    ate, _ = metrics.ate_rmse(gt, est)
    rpe_t, rpe_r, _ = metrics.rpe(gt, est, fixed_delta=min(0.4, args.frames / 60))
    print(
        json.dumps(
            {
                "frames": args.frames,
                "fps": round(args.frames / elapsed, 2),
                "ate_rmse_m": round(ate, 6),
                "rpe_trans_rmse_m": round(rpe_t, 6),
                "landmarks": n_landmarks,
            }
        )
    )
    if viz is not None:
        if args.viz_hold > 0:
            # keep the viewer inspectable after the replay finishes (a replay
            # on a short synthetic stream outruns any human looking at the page)
            print(f"live viewer holding at http://127.0.0.1:{viz.port}/ for {args.viz_hold:.0f}s",
                  file=sys.stderr, flush=True)
            time.sleep(args.viz_hold)
        viz.close()
    return 0


def _cmd_reproduce(args) -> int:
    """One-command replication of the reference's published benchmark: track
    the dataset end-to-end, then score the trajectory with the OPTION-EXACT
    reference protocols — RPE `--fixed_delta --delta_unit s` and ATE, exactly
    what `script/evaluate.py:60-75` runs after a replay — and print pass/fail
    against the published fr2_desk numbers (RPE 0.036 m / ATE 0.21 m,
    `README.md:10-12`; CI shape: `.gitlab-ci.yml:25-28`).

    The moment a real `rgbd_dataset_freiburg2_desk` checkout is reachable:

        vslam-run reproduce --dataset /data/rgbd_dataset_freiburg2_desk

    Exit code 0 = both budgets met, 1 = regression, 2 = usage error.
    `scripts/fetch_tum.sh` documents the dataset download for a connected
    machine."""
    import numpy as np

    from ..io import tum
    from . import metrics

    out = args.out or os.path.join(
        os.path.dirname(args.dataset.rstrip(os.sep)) or ".",
        os.path.basename(args.dataset.rstrip(os.sep)) + ".trajectory.txt",
    )
    # 1) replay: the fused production profile by default (--parity for the
    #    reference-parity dense gather semantics); full SLAM via --mapping
    odo_args = argparse.Namespace(
        dataset=[args.dataset],
        format="tum",
        sequence="00",
        out=out,
        config=args.config,
        max_frames=args.max_frames,
        intrinsics=args.intrinsics,
        mapping=args.mapping,
        fused=not args.host_loop,
        parity=args.parity,
        chunk=args.chunk,
        no_eval=True,
        log_level=args.log_level,
        profile_dir=None,
        live_viz=None,  # no viewer during a reproduce replay
        device=args.device,
    )
    rc = _cmd_odometry(odo_args)
    if rc != 0:
        return rc

    # 2) score with the reference protocols
    gt_path = os.path.join(args.dataset, "groundtruth.txt")
    if not os.path.exists(gt_path):
        print(f"no ground truth at {gt_path}", file=sys.stderr)
        return 2
    gt = tum.read_trajectory(gt_path)
    est = tum.read_trajectory(out)
    try:
        rows = metrics.evaluate_rpe_full(
            gt, est, fixed_delta=True, delta=1.0, delta_unit="s"
        )
        rpe_stats = metrics.rpe_stats(rows)
        rpe_m = float(rpe_stats["translational_error.rmse"])
        rpe_pairs = int(rpe_stats["compared_pose_pairs"])
        rpe_ok = rpe_m <= args.rpe_budget
    except ValueError:
        # sequence shorter than the 1 s fixed delta (protocol raises, like
        # the reference script) — ATE is then the binding check
        rpe_m, rpe_pairs, rpe_ok = None, 0, True
    ate_stats, _, _ = metrics.evaluate_ate_full(gt, est)
    ate_m = float(ate_stats["absolute_translational_error.rmse"])
    ok = rpe_ok and ate_m <= args.ate_budget
    print(json.dumps({
        "dataset": args.dataset,
        "trajectory": out,
        "rpe_trans_rmse_m": round(rpe_m, 5) if rpe_m is not None else None,
        "rpe_budget_m": args.rpe_budget,
        "ate_rmse_m": round(ate_m, 5),
        "ate_budget_m": args.ate_budget,
        "compared_rpe_pairs": rpe_pairs,
        "compared_ate_pairs": int(ate_stats["compared_pose_pairs"]),
        "pass": bool(ok),
        "reference": "RPE 0.036 m / ATE 0.21 m on fr2_desk (README.md:10-12)",
        "git_sha": _git_sha(),
    }))
    return 0 if ok else 1


def _git_sha() -> str:
    try:
        return (
            subprocess.run(
                ["git", "rev-parse", "HEAD"], capture_output=True, text=True, timeout=5
            ).stdout.strip()
            or "unknown"
        )
    except Exception:
        return "unknown"


def parser() -> argparse.ArgumentParser:
    """The CLI's argument parser: the JAX CLI's subcommands and flags, plus
    ``--device`` on the commands that track."""
    ap = argparse.ArgumentParser(prog="vslam-run", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("odometry", help="track a TUM RGB-D sequence")
    p.add_argument(
        "--dataset",
        required=True,
        action="append",
        help="sequence directory (a KITTI root with --format kitti); repeat to "
        "track several sequences in lock-step through the multi-sequence fused scan",
    )
    p.add_argument("--format", choices=["tum", "kitti"], default="tum")
    p.add_argument("--sequence", default="00", help="KITTI sequence id")
    p.add_argument("--out", default=None)
    p.add_argument("--config", default=None, help="reference-style YAML params")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--intrinsics", default=None, help="fx,fy,cx,cy override (default: inferred)")
    p.add_argument("--mapping", action="store_true", help="enable SLAM backend (features + BA)")
    p.add_argument("--fused", action="store_true", help="fused on-device scan path")
    p.add_argument(
        "--parity",
        action="store_true",
        help="with --fused: keep the reference-parity dense gather profile "
        "instead of the fast in-kernel production profile",
    )
    p.add_argument("--chunk", type=int, default=16, help="frames per device dispatch with --fused")
    p.add_argument("--no-eval", action="store_true")
    p.add_argument(
        "--live-viz",
        type=int,
        default=None,
        metavar="PORT",
        help="serve the live trajectory viewer on PORT (0 = ephemeral); "
        "the RViz channel without ROS (see vslam_tpu_torch.viz)",
    )
    p.add_argument("--log-level", default="WARNING")
    p.add_argument(
        "--profile-dir",
        default=None,
        help="capture a torch.profiler trace into this directory (Chrome "
        "trace format; the reference's TIMED_FUNC perf tracking + "
        "kcachegrind role)",
    )
    p.add_argument("--device", default="cuda", help="torch device to track on (default cuda)")
    p.set_defaults(fn=_cmd_odometry)

    p = sub.add_parser("evaluate", help="ATE/RPE of trajectory vs ground truth")
    p.add_argument("--gt", required=True)
    p.add_argument("--algo", required=True)
    p.add_argument("--fixed-delta", type=float, default=1.0)
    p.add_argument("--max-difference", type=float, default=0.02)
    p.add_argument("--plot", action="store_true", help="write traj/rpe PNGs next to --algo")
    p.set_defaults(fn=_cmd_evaluate)

    p = sub.add_parser(
        "ate", help="ATE, the reference evaluate_ate.py interface"
    )
    p.add_argument("--gt", required=True, help="ground truth trajectory (TUM format)")
    p.add_argument("--algo", required=True, help="estimated trajectory (TUM format)")
    p.add_argument("--offset", type=float, default=0.0)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--max-difference", type=float, default=0.02)
    p.add_argument("--save", help="aligned estimated trajectory (stamp x y z)")
    p.add_argument(
        "--save-associations",
        help="associated gt + aligned est (stamp1 xyz1 stamp2 xyz2)",
    )
    p.add_argument("--plot", help="png path for the gt-vs-aligned plot")
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=_cmd_ate)

    p = sub.add_parser(
        "rpe", help="RPE, the reference evaluate_rpe.py interface"
    )
    p.add_argument("--gt", required=True, help="ground truth trajectory (TUM format)")
    p.add_argument("--algo", required=True, help="estimated trajectory (TUM format)")
    p.add_argument("--max-pairs", type=int, default=10000)
    p.add_argument("--fixed-delta", action="store_true")
    p.add_argument("--delta", type=float, default=1.0)
    p.add_argument("--delta-unit", default="s", choices=["s", "m", "rad", "deg", "f"])
    p.add_argument("--offset", type=float, default=0.0)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--save", help="per-pair dump (the reference --save format)")
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=_cmd_rpe)

    p = sub.add_parser(
        "reproduce",
        help="replay a TUM sequence + reference-protocol RPE/ATE, pass/fail "
        "vs the published fr2_desk numbers",
    )
    p.add_argument("--dataset", required=True, help="TUM sequence directory")
    p.add_argument("--out", default=None, help="trajectory output path")
    p.add_argument("--config", default=None, help="reference-style YAML params")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--intrinsics", default=None, help="fx,fy,cx,cy override")
    p.add_argument("--mapping", action="store_true", help="full SLAM backend")
    p.add_argument("--parity", action="store_true",
                   help="reference-parity dense gather profile")
    p.add_argument("--host-loop", action="store_true",
                   help="per-frame host pipeline instead of the fused scan")
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--rpe-budget", type=float, default=0.036,
                   help="published reference RPE on fr2_desk [m]")
    p.add_argument("--ate-budget", type=float, default=0.21,
                   help="published reference ATE on fr2_desk [m]")
    p.add_argument("--log-level", default="WARNING")
    p.add_argument("--device", default="cuda", help="torch device to track on (default cuda)")
    p.set_defaults(fn=_cmd_reproduce)

    p = sub.add_parser("synthetic", help="dataset-free end-to-end run")
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--height", type=int, default=96)
    p.add_argument("--fx", type=float, default=110.0)
    p.add_argument("--mapping", action="store_true")
    p.add_argument("--fused", action="store_true", help="fused on-device scan path")
    p.add_argument(
        "--realistic",
        action="store_true",
        help="occlusion scene + sensor noise/holes/exposure drift (accuracy proxy)",
    )
    p.add_argument(
        "--live-viz",
        type=int,
        default=None,
        metavar="PORT",
        help="serve the live trajectory viewer on PORT (0 = ephemeral)",
    )
    p.add_argument(
        "--viz-hold",
        type=float,
        default=0.0,
        metavar="SEC",
        help="keep the live viewer serving for SEC seconds after the run",
    )
    p.add_argument(
        "--profile-dir",
        default=None,
        help="capture a torch.profiler trace into this directory (Chrome "
        "trace format; the reference's TIMED_FUNC perf tracking + "
        "kcachegrind role)",
    )
    p.add_argument("--device", default="cuda", help="torch device to track on (default cuda)")
    p.set_defaults(fn=_cmd_synthetic)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if getattr(args, "profile_dir", None):
        from ..utils.profiling import trace

        with trace(args.profile_dir):
            return args.fn(args)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
