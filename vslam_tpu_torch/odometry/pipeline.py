"""Per-frame odometry pipeline: the host loop that replaces the reference's
ROS node graph.

Port of `vslam_tpu.odometry.pipeline`. The replayer's lock-step pairing
becomes a Python for-loop; per frame (NodeMapping.cpp:142-180): frame build
on the device, motion prediction, dense alignment, keyframe policy, map
insert, on keyframes the mapping backend (feature tracking, windowed BA,
loop closure; `enable_mapping`, `enable_loop_closure`), trajectory append.
Two schedules:

* the strict loop, `process_frame`: the host predicts in f64, the aligner
  builds, precomputes and aligns the frame against the cached data of its
  references (`RgbdAligner.align_build`) and the host waits for the pose;
  the first frame, and every frame while a visual-log sink is on, is built
  on its own and aligned by `OdometryRgbd.update`;
* the software-pipelined loop, `run(pipelined=None)` for the eligible
  configs: the pose chain stays on the device in f32 (`_chain_step`), so
  frame i + 1 is queued before frame i's pose reaches the host, and the
  host fetches the poses of `retire_depth` frames at a time.

There is no `jit` here: `_chain_step` and `aligner.build_frame` are plain functions
that queue the device work and never wait for it.

    pipeline = OdometryPipeline(Camera.create(fx, fy, cx, cy), PipelineConfig())  # on CUDA
    trajectory = pipeline.run(stream)  # (t_ns, intensity, depth) items

With ``live_viz_port`` set, a `viz.LiveViz` serves the trajectory: each
frame's pose, covariance and twist as the host already holds them (the
reference's /odom, /path and TF publish, NodeMapping.cpp:231-272), keyframe
markers, and the map's landmarks on keyframes with mapping on.
"""

from __future__ import annotations

import collections
import time
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from ..alignment import ic
from ..alignment.aligner import RgbdAligner, build_frame, stack_level_data
from ..config import PipelineConfig
from ..core import se3
from ..core.camera import Camera
from ..core.device import resolve
from ..core.se3 import SE3
from ..utils import timer
from ..utils.log import get_logger, log_img, log_plt
from ..utils.tree import tree_map
from .keyframe import make_keyframe_selection
from .map import HostFrame, Map
from .motion_model import make_motion_prediction
from .odometry import OdometryRgbd
from .sequential import _upload
from .trajectory import Trajectory

__all__ = ["OdometryPipeline", "device_prefetch"]

_IMAGE_SINKS = ("ImageWarped", "Residual", "Weights")


def _sinks_on() -> bool:
    return any(log_img(n).enabled for n in _IMAGE_SINKS) or log_plt("SolverGN").enabled


def _chain_step(intensity, depth, camera: Camera, kf_data, last_data, pose_kf: SE3, pose_last: SE3,
                speed: torch.Tensor, dt: float, cfg, n_levels: int, depth_scale: float,
                prediction_model: str, include_kf: bool):
    """One frame's whole update with the pose chain on the device: frame
    build, precompute, constant-motion prediction from the device-resident
    chain, the joint {keyframe, last} alignment and the speed update, all
    queued without a host wait (the host's only input is the image and dt).
    Poses are unbatched SE3 (3, 3), (3); the math is the sequential scan's
    step (`sequential._step`; NodeRgbdAlignment.cpp:121-149). Returns
    (frame, level_data, pose, cov (6, 6), ok (), speed (6,))."""
    frame, cur_data = build_frame(intensity, depth, camera, cfg, n_levels, depth_scale)

    if prediction_model == "ConstantMotion":
        pred = se3.compose(se3.exp(speed * dt), pose_last)
    else:  # NoMotion
        pred = pose_last
    rel_l = se3.compose(pred, se3.inverse(pose_last))
    if include_kf:
        ref_data = stack_level_data([kf_data, last_data])
        rel_k = se3.compose(pred, se3.inverse(pose_kf))
        rel_init = SE3(torch.stack([rel_k.R, rel_l.R])[None], torch.stack([rel_k.t, rel_l.t])[None])
        x_pred = torch.stack([se3.log(rel_k), se3.log(rel_l)])[None]
        pose_ref0 = pose_kf
    else:
        ref_data = stack_level_data([last_data])
        rel_init = SE3(rel_l.R[None, None], rel_l.t[None, None])
        x_pred = se3.log(rel_l)[None, None]
        pose_ref0 = pose_last

    rel, cov, ok = ic.align(None, tree_map(lambda x: x[None], frame), rel_init, x_pred, cfg,
                            ref_data=ref_data)
    ok = ok[0]
    pose_al = se3.orthonormalize(se3.compose(SE3(rel.R[0, 0], rel.t[0, 0]), pose_ref0))
    pose_new = SE3(torch.where(ok, pose_al.R, pred.R), torch.where(ok, pose_al.t, pred.t))
    rel_last = se3.compose(pose_new, se3.inverse(pose_last))
    v = se3.log(rel_last) / max(dt, 1e-6)
    speed_new = torch.where(ok & (dt > 0), v, torch.zeros_like(v))
    return frame, cur_data, pose_new, cov[0], ok, speed_new


class OdometryPipeline:
    """Streaming odometry: feed (t_ns, intensity, depth) frames, collect a
    trajectory. Runs on ``device``, CUDA unless named; the camera's
    intrinsics are moved there."""

    def __init__(self, camera: Camera, cfg: PipelineConfig = PipelineConfig(), device=None):
        self.cfg = cfg
        self.device = resolve(device)
        self.camera = Camera(*(torch.as_tensor(c, dtype=torch.float32, device=self.device) for c in camera))
        self.map = Map()
        self._align_cfg = cfg.alignment_config()
        self.aligner = RgbdAligner(self._align_cfg)
        self.odometry = OdometryRgbd(
            self.aligner,
            self.map,
            include_key_frame=cfg.include_key_frame,
            track_key_frame=cfg.track_key_frame,
        )
        self.prediction = make_motion_prediction(cfg.prediction_model, device=self.device)
        self.keyframe_selection = make_keyframe_selection(
            cfg.keyframe_selection_method,
            self.map,
            period=cfg.keyframe_selection_idx_period,
            min_visible_points=cfg.keyframe_selection_min_visible_points,
            max_translation=cfg.keyframe_selection_max_translation,
        )
        self.trajectory = Trajectory()
        self.viz = None
        self._log = get_logger("odometry")
        # the visual-log sinks the config asks for (NodeMapping.cpp:125-135)
        for name in cfg.log_image_enabled:
            log_img(name).enabled = True
        for name in cfg.log_plot_enabled:
            log_plt(name).enabled = True
        # the keyframe backend (NodeMapping.cpp:162-180), on the pipeline's device
        self._tracking = None
        self._ba = None
        self._graph = None
        if cfg.enable_mapping or cfg.enable_loop_closure:
            from ..features.tracking import FeatureTracking

            self._tracking = FeatureTracking(device=self.device)
        if cfg.enable_mapping:
            from ..ba.bundle_adjustment import BundleAdjustment

            self._ba = BundleAdjustment(max_iterations=cfg.ba_max_iterations,
                                        compute_pose_covariance=(cfg.ba_pose_write_back == "gated"),
                                        device=self.device)
        if cfg.enable_loop_closure:
            from .graph_backend import PoseGraphBackend

            self._graph = PoseGraphBackend(device=self.device)
        if cfg.live_viz_port is not None:
            from ..viz import LiveViz

            self.viz = LiveViz(port=cfg.live_viz_port)

    def process_frame(self, t_ns: int, intensity, depth) -> Tuple[np.ndarray, np.ndarray]:
        """One frame of the strict loop: (H, W) images in a sensor dtype
        (numpy, or tensors staged by `device_prefetch`). Returns (pose
        world->cam 4x4, cov 6x6)."""
        t0 = time.perf_counter()
        with timer.scope("pipeline.predict"):
            pred = self.prediction.predict(t_ns)

        last, ref_hosts = self.odometry.select_refs()
        if last is not None and not _sinks_on() and all(h.level_data is not None for h in ref_hosts):
            # build, precompute and align in one call, one fetch
            with timer.scope("pipeline.step"):
                device_frame, level_data, pose, cov, ok = self.aligner.align_build(
                    intensity, depth, self.camera, self.cfg.pyramid_levels,
                    [h.level_data for h in ref_hosts], [h.pose for h in ref_hosts], pred,
                    depth_scale=self.cfg.depth_scale,
                )
            frame = HostFrame(frame=device_frame, t_ns=int(t_ns), pose=pred, level_data=level_data)
            self.odometry.commit(frame, pose, cov, ok, last)
        else:
            # the first frame, or a visual-log sink on: build, then align
            # (the align call services the per-iteration sinks)
            with timer.scope("pipeline.create_frame"):
                device_frame, level_data = build_frame(intensity, depth, self.camera, self._align_cfg,
                                                       self.cfg.pyramid_levels, self.cfg.depth_scale)
            frame = HostFrame(frame=device_frame, t_ns=int(t_ns), pose=pred, level_data=level_data)
            with timer.scope("pipeline.align"):
                self.odometry.update(frame)
        frame.pose = self.odometry.pose
        frame.cov = self.odometry.cov

        self.prediction.update(frame.pose, t_ns, cov=frame.cov)
        self.keyframe_selection.update(frame)
        is_kf = self.keyframe_selection.is_keyframe() or self.map.last_kf() is None
        self.map.insert(frame, is_kf)
        if is_kf and self._tracking is not None:
            self._keyframe_backend(frame, t_ns)
        self.trajectory.append(t_ns, frame.pose, frame.cov)
        if self.viz is not None:
            self._publish_viz(t_ns, frame, is_kf)
        timer.record("pipeline.frame_total", time.perf_counter() - t0)
        self._log.debug("frame t=%d kf=%s dt=%.1fms", t_ns, is_kf, 1e3 * (time.perf_counter() - t0))
        return frame.pose, frame.cov

    def _publish_viz(self, t_ns: int, frame: HostFrame, is_kf: bool) -> None:
        """Feed the live viewer: the frame's odometry (pose, covariance and
        the prediction's host-cached twist; NodeMapping.cpp:255-271), a
        keyframe marker, and on keyframes with mapping on the map's cloud."""
        self.viz.publish_odometry(t_ns, frame.pose, cov=frame.cov, twist=self.prediction.speed_host())
        if is_kf:
            self.viz.publish_keyframe(t_ns, frame.pose)
            if self.cfg.enable_mapping:
                pts = self.map.points()
                if pts:
                    self.viz.publish_landmarks(np.stack([p.position for p in pts]))

    def _keyframe_backend(self, frame: HostFrame, t_ns: int) -> None:
        """Track the keyframe, run the windowed BA and try a loop closure,
        writing corrections back (NodeMapping.cpp:162-180). A failure is
        logged on the "mapping" logger and the frame keeps its odometry
        pose (NodeMapping.cpp:176-178)."""
        try:
            with timer.scope("pipeline.mapping"):
                if self.cfg.enable_mapping:
                    self.map.insert_points(self._tracking.track(frame, self.map))
                else:  # loop closure only: features without landmarks
                    self._tracking.extract(frame)
            if self._ba is not None and len(self.map.keyframes()) >= 2:
                from ..ba.bundle_adjustment import write_back

                corrected = write_back(self._ba, self.map, self._graph, frame.id, frame.pose,
                                       self.cfg.ba_pose_write_back)
                if corrected is not None:
                    frame.pose = corrected
            if self._graph is not None:
                with timer.scope("pipeline.loop_closure"):
                    self._graph.add_keyframe(frame)
                    corrections = self._graph.try_close(frame)
                if corrections:
                    # corrected keyframe poses into the window; the live pose
                    # only when the correction beats the closure's own noise
                    in_window = {f.id for f in self.map.keyframes()} | {f.id for f in self.map.frames()}
                    for fid, T in corrections.items():
                        if fid in in_window:
                            self.map.update_pose(fid, T)
                    if self._graph.last_closure_significant:
                        frame.pose = corrections.get(frame.id, frame.pose)
                        self.prediction.update(frame.pose, t_ns, cov=frame.cov)
        except Exception as exc:
            get_logger("mapping").warning("mapping backend failed: %s", exc)

    def run(self, stream: Iterable[Tuple[int, np.ndarray, np.ndarray]],
            pipelined: Optional[bool] = None) -> Trajectory:
        """Replay a stream. ``pipelined=None`` runs the software-pipelined
        loop where the config is eligible (the same keyframe schedule and,
        within f32, the same poses as the strict loop); ``pipelined=False``
        forces the strict one-frame-at-a-time loop."""
        if pipelined is None:
            pipelined = self._pipelined_eligible()
        if not pipelined:
            for t_ns, intensity, depth in device_prefetch(stream, device=self.device):
                self.process_frame(t_ns, intensity, depth)
            return self.trajectory
        return self._run_pipelined(stream)

    def _pipelined_eligible(self) -> bool:
        """idx keyframes, ConstantMotion or NoMotion prediction, no mapping
        backend and no visual-log sink: nothing then needs frame i's host
        pose before frame i + 1 is queued."""
        cfg = self.cfg
        return (
            cfg.keyframe_selection_method == "idx"
            and cfg.prediction_model in ("ConstantMotion", "NoMotion")
            and not cfg.enable_mapping
            and not cfg.enable_loop_closure
            and not _sinks_on()
        )

    def _run_pipelined(self, stream, retire_depth: int = 4) -> Trajectory:
        """Queue each frame's whole update without waiting (`_chain_step`)
        and retire the pending frames' results `retire_depth` at a time,
        one fetch a batch. Frames are consumed in order and every frame has
        its pose when the run returns; the host's map, trajectory and
        prediction lag the queue by at most `retire_depth` frames, which the
        eligible configs never read while queueing."""
        pending: list = []
        for t_ns, inten, depth in device_prefetch(stream, depth=2, device=self.device):
            if self.map.last_frame() is None:
                # the first frame starts the chain and the map through the
                # strict path (no alignment), then seeds the device chain
                self.process_frame(t_ns, inten, depth)
                f0 = self.map.last_frame()
                pose = SE3(torch.as_tensor(f0.pose[:3, :3], dtype=torch.float32, device=self.device),
                           torch.as_tensor(f0.pose[:3, 3], dtype=torch.float32, device=self.device))
                self._pl = {"kf_data": f0.level_data, "last_data": f0.level_data, "pose_kf": pose,
                            "pose_last": pose, "speed": torch.zeros(6, device=self.device),
                            "t_last": int(t_ns)}
                self._prev_retired = f0
                continue
            pending.append(self._dispatch_chain(t_ns, inten, depth))
            if len(pending) >= retire_depth:
                self._retire_batch(pending)
                pending = []
        if pending:
            self._retire_batch(pending)
        return self.trajectory

    def _dispatch_chain(self, t_ns: int, inten, depth):
        pl = self._pl
        dt = (int(t_ns) - pl["t_last"]) / 1e9
        with timer.scope("pipeline.dispatch"):
            frame_dev, cur_data, pose_new, cov, ok, speed_new = _chain_step(
                inten, depth, self.camera, pl["kf_data"], pl["last_data"], pl["pose_kf"],
                pl["pose_last"], pl["speed"], dt, self._align_cfg, self.cfg.pyramid_levels,
                self.cfg.depth_scale, self.cfg.prediction_model, self.cfg.include_key_frame,
            )
        hf = HostFrame(frame=frame_dev, t_ns=int(t_ns), pose=np.eye(4), level_data=cur_data)
        # the idx policy needs no pose, so the schedule is known here, from
        # the policy object the strict loop uses
        self.keyframe_selection.update(hf)
        is_kf = self.keyframe_selection.is_keyframe()
        pl.update(last_data=cur_data, pose_last=pose_new, speed=speed_new, t_last=int(t_ns))
        if is_kf:
            pl.update(kf_data=cur_data, pose_kf=pose_new)
        return hf, pose_new, cov, ok, is_kf

    def _retire_batch(self, recs: list) -> None:
        """One fetch for a batch of queued frames (the host waits here),
        then the host bookkeeping of each, in order."""
        with timer.scope("pipeline.retire"):
            flat = torch.stack([torch.cat([p.R.reshape(9), p.t.reshape(3), cov.reshape(36),
                                           ok.reshape(1).to(cov.dtype)])
                                for _, p, cov, ok, _ in recs]).cpu().double().numpy()
        for (hf, _, _, _, is_kf), row in zip(recs, flat):
            self._retire_chain(hf, row, is_kf)

    def _retire_chain(self, hf: HostFrame, row: np.ndarray, is_kf: bool) -> None:
        T = np.eye(4)
        u, _, vt = np.linalg.svd(row[:9].reshape(3, 3))
        T[:3, :3] = u @ vt
        T[:3, 3] = row[9:12]
        hf.pose = T
        hf.cov = row[12:48].reshape(6, 6)
        # the host odometry and prediction state stay coherent, so a later
        # strict process_frame call continues the chain
        self.odometry.commit(hf, T, hf.cov, bool(row[48]), self._prev_retired)
        self.prediction.update(hf.pose, hf.t_ns, cov=hf.cov)
        self.map.insert(hf, is_kf)
        self.trajectory.append(hf.t_ns, hf.pose, hf.cov)
        if self.viz is not None:
            self._publish_viz(hf.t_ns, hf, is_kf)
        self._prev_retired = hf


def device_prefetch(stream: Iterable[Tuple[int, np.ndarray, np.ndarray]], depth: int = 2,
                    device=None) -> Iterable[Tuple[int, torch.Tensor, torch.Tensor]]:
    """Stage frames on ``device`` (CUDA unless named) ``depth`` frames ahead
    of the consumer: each image is copied from pinned memory without
    waiting (`sequential._upload`; uint16 depth travels as int16 bits), so
    frame i + depth crosses the link while frame i is solved. Frames are
    consumed strictly in order."""
    device = resolve(device)
    buf = collections.deque()
    for t_ns, intensity, depth_img in stream:
        buf.append((t_ns, _upload(np.asarray(intensity), device), _upload(np.asarray(depth_img), device)))
        if len(buf) > depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
