"""Mapping backend of the sequential scan: full SLAM between chunks.

Port of `vslam_tpu.odometry.sequential_mapping`. The scan (`sequential.py`)
tracks on the device; this backend runs the reference's keyframe backend
between chunks, the track -> insert -> windowed BA -> (optional) loop
closure sequence of `NodeMapping::processFrame` (NodeMapping.cpp:162-180),
batched per chunk:

- the scan flags keyframes; only those get features, detected for a whole
  chunk in one batched call on the scan's device (`dispatch_detect`,
  queued from the main thread right behind the chunk's scan, its results
  copied into pinned host memory without waiting, a CUDA event recorded);
- matching, BA and the pose graph run on ``compute_device``: "auto" (and
  "cpu") puts them on the CPU, so a backend worker thread computes beside
  the scan (the reference's topology: NodeMapping's thread on the host)
  and launches nothing on the card, only waiting on the detection's event;
  "default" keeps everything on the scan's device;
- BA and loop-closure corrections fold back into the device pose chain as
  one right-composed delta (pose' = pose . T_est^-1 . T_corr, pivoting at
  the corrected keyframe; `SequentialOdometry._apply_correction`), as the
  reference's write-back (`Map::updatePoses`) steers tracking.

Failures degrade gracefully, per keyframe and per chunk, with a warning on
the "mapping" logger (NodeMapping.cpp:176-178); everything else it reports
logs below the warning level.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import lie_np
from ..core.camera import Camera
from ..core.device import resolve
from ..core.frame import Frame
from ..core.se3 import SE3
from ..utils import timer
from ..utils.log import get_logger
from .map import HostFrame, Map
from .sequential import _sensor_f32, _upload

__all__ = ["ChunkMappingBackend", "anchor_trajectory", "DetectOut"]

# frames per detection call: FAST's ring planes and the stereo cost volumes
# of a call are temporaries of this many frames
DETECT_BATCH = 4
# torch's intra-op threads while a chunk's matching, BA and graph run on the
# CPU: the problems are small (a 7-keyframe window, a few hundred
# landmarks) and the thread shares the host with the scan driver, which a
# thread per core spins against (OpenMP's count is per thread)
CPU_THREADS = 1


def anchor_trajectory(results: List[Tuple[int, np.ndarray, np.ndarray]],
                      kf_trajectory: List[Tuple[int, np.ndarray]]) -> List[Tuple[int, np.ndarray, np.ndarray]]:
    """Re-anchor an odometry trajectory on globally optimized keyframe poses
    (the trajectory after loop closures, what a TUM evaluation scores).

    Each frame is rewritten relative to the latest keyframe at or before it:
    T' = T @ inv(T_kf_output) @ T_kf_final, exact for keyframes, and the
    frames between keep their measured camera-relative motion off the
    corrected keyframe. ``kf_trajectory``: (t_ns, final pose) per keyframe,
    sorted (`PoseGraphBackend.keyframe_trajectory`); stamps missing from
    ``results`` are skipped."""
    if not kf_trajectory:
        return results
    out_by_t = {int(t): np.asarray(T, np.float64) for t, T, _ in results}
    anchors: List[Tuple[int, np.ndarray]] = []
    for t_kf, T_final in kf_trajectory:
        T_out = out_by_t.get(int(t_kf))
        if T_out is None:
            continue
        anchors.append((int(t_kf), lie_np.inv(T_out) @ np.asarray(T_final, np.float64)))
    if not anchors:
        return results
    anchor_ts = np.asarray([a[0] for a in anchors], np.int64)
    corrected = []
    for t_ns, T, cov in results:
        k = int(np.searchsorted(anchor_ts, int(t_ns), side="right")) - 1
        delta = anchors[k][1] if k >= 0 else np.eye(4)
        corrected.append((t_ns, np.asarray(T, np.float64) @ delta, cov))
    return corrected


def _light_arrays(intensity: torch.Tensor, second: torch.Tensor, fx, depth_scale: float,
                  stereo_baseline: float, max_disparity: int):
    """Level-0 (intensity f32, depth metres) of (..., H, W) sensor images
    already on the device: depth block-matched from the right image in
    stereo, else the counts times ``depth_scale``, as the scan step does."""
    inten = _sensor_f32(intensity)
    if stereo_baseline > 0.0:
        from ..io.kitti import stereo_depth

        depth = stereo_depth(inten, _sensor_f32(second), fx, stereo_baseline, max_disparity=max_disparity)
    else:
        depth = _sensor_f32(second) * depth_scale
    return inten, depth


def _light_detect_batch(intensity, second, fx, depth_scale: float, stereo_baseline: float,
                        max_disparity: int, threshold: float, cell: int):
    """Level-0 conversion and FAST/BRIEF extraction for (n, H, W) frames,
    DETECT_BATCH frames a call. Returns (intensity, depth, uv, response,
    valid, packed descriptors, keypoint depth), each with a leading n."""
    from ..features.tracking import _detect_describe

    parts = []
    for s in range(0, intensity.shape[0], DETECT_BATCH):
        inten, depth = _light_arrays(intensity[s : s + DETECT_BATCH], second[s : s + DETECT_BATCH], fx,
                                     depth_scale, stereo_baseline, max_disparity)
        parts.append((inten, depth) + _detect_describe(inten, depth, threshold=threshold, cell=cell))
    return tuple(torch.cat(p) if len(parts) > 1 else p[0] for p in zip(*parts))


def _light_frame(inten: torch.Tensor, depth: torch.Tensor, zeros: torch.Tensor, cam_host: Camera) -> Frame:
    """One-level Frame for the backend: derivative planes are zeros (nothing
    in the feature, BA or loop-closure path reads them), the camera holds
    host scalars and the pose is a host identity (the HostFrame carries the
    f64 pose chain)."""
    return Frame(intensity=(inten,), depth=(depth,), dIx=(zeros,), dIy=(zeros,), cameras=(cam_host,),
                 pose=SE3(np.eye(3, dtype=np.float32), np.zeros(3, np.float32)))


class DetectOut(NamedTuple):
    """A queued batched detection (`ChunkMappingBackend.dispatch_detect`)."""

    rows: List[int]  # the chunk frames it covers, in row order
    intensity: torch.Tensor  # (n, H, W) level-0 planes on the scan's device
    depth: torch.Tensor
    zeros: torch.Tensor  # (H, W)
    features: Tuple[torch.Tensor, ...]  # host copies of (uv, response, valid, descriptors, depth)
    event: Optional[object]  # torch.cuda.Event the copies complete at, or None


class ChunkMappingBackend:
    def __init__(self, enable_ba: bool = True, enable_loop_closure: bool = False, ba_max_iterations: int = 20,
                 pose_write_back: str = "gated", min_correction: float = 1e-3, ba_schedule: str = "chunk",
                 track_schedule: str = "chunk", compute_device: str = "auto", tracking=None,
                 loop_closure_cfg=None, fold_min_span_frac=None, device=None):
        """``device``: the scan's device, where detection runs (CUDA unless
        named). ``tracking``: a FeatureTracking override (detector tuning).
        ``fold_min_span_frac`` > 1 makes loop closures refine the graph
        (and the post-run anchoring) without touching the live chain.

        ``pose_write_back``: "always" persists every BA solution (the
        reference's Map::updatePoses, NodeMapping.cpp:170-175); "gated"
        keeps keyframe poses odometry-anchored and folds a correction into
        the newest keyframe and the device chain only when it is
        significant under BA's own pose covariance (Mahalanobis > chi2_6 at
        99 %, `ba.bundle_adjustment.drift_significant`) and above
        ``min_correction``; "off" refines the map only.
        ``ba_schedule``: "chunk" solves once per chunk, "keyframe" once per
        keyframe (NodeMapping.cpp:166). ``track_schedule``: "chunk" matches
        all of a chunk's keyframes in one call (`FeatureTracking.
        track_batch`), "keyframe" one at a time (FeatureTracking.cpp:
        71-203); per-keyframe BA implies the per-keyframe cadence."""
        from ..features.tracking import FeatureTracking

        if pose_write_back not in ("gated", "always", "off"):
            raise ValueError(f"unknown pose_write_back {pose_write_back!r}")
        if ba_schedule not in ("chunk", "keyframe"):
            raise ValueError(f"unknown ba_schedule {ba_schedule!r}")
        if track_schedule not in ("chunk", "keyframe"):
            raise ValueError(f"unknown track_schedule {track_schedule!r}")
        if compute_device not in ("auto", "cpu", "default"):
            raise ValueError(f"unknown compute_device {compute_device!r}")
        self.ba_schedule = ba_schedule
        self.track_schedule = track_schedule
        self.pose_write_back = pose_write_back
        self.min_correction = float(min_correction)
        self.device = resolve(device)
        # where matching, BA and the pose graph run: the CPU unless "default"
        self.compute_device = self.device if compute_device == "default" else torch.device("cpu")
        self.map = Map()
        self._tracking = tracking if tracking is not None else FeatureTracking(device=self.device)
        self._tracking.compute_ctx = self._compute_ctx
        self._ba = None
        self._graph = None
        if enable_ba:
            from ..ba.bundle_adjustment import BundleAdjustment

            self._ba = BundleAdjustment(max_iterations=ba_max_iterations,
                                        compute_pose_covariance=(pose_write_back == "gated"),
                                        device=self.compute_device)
        if enable_loop_closure:
            from .graph_backend import PoseGraphBackend

            kw = {"device": self.compute_device}
            if loop_closure_cfg is not None:
                kw["cfg"] = loop_closure_cfg
            if fold_min_span_frac is not None:
                kw["fold_min_span_frac"] = fold_min_span_frac
            self._graph = PoseGraphBackend(**kw)
        self._log = get_logger("mapping")
        self._cam_host: Optional[Camera] = None  # host-scalar intrinsics
        # chunks whose keyframes took the batched detection / the batched match
        self.batched_detect_chunks = 0
        self.batched_track_chunks = 0

    def _compute_ctx(self):
        """The matching placement (`FeatureTracking.compute_ctx`): its value
        is the compute device."""
        return contextlib.nullcontext(self.compute_device)

    @property
    def n_landmarks(self) -> int:
        return len(self.map.points())

    @property
    def n_closures(self) -> int:
        return self._graph.n_closures if self._graph is not None else 0

    def corrected_trajectory(self, results):
        """The odometry output re-anchored on the pose graph's optimized
        keyframe poses (unchanged without a loop-closure graph)."""
        if self._graph is None:
            return results
        return anchor_trajectory(results, self._graph.keyframe_trajectory())

    def dispatch_detect(self, kf_js, device_images, camera, cfg) -> DetectOut:
        """Queue the batched feature extraction of a chunk's frames
        (``kf_js``, or all with None) from the staged (K, H, W) sensor images
        on the scan's device, and the copy of its features into pinned host
        memory, without waiting. The scan driver calls it on its own thread
        right behind the chunk's scan: queued any later, it would wait
        behind the next scan on the device."""
        if kf_js is None:
            rows = list(range(device_images[0].shape[0]))
            imgs = device_images
        else:
            rows = [int(j) for j in kf_js]
            idx = torch.as_tensor(rows, device=device_images[0].device)
            imgs = (device_images[0][idx], device_images[1][idx])
        out = _light_detect_batch(imgs[0], imgs[1], camera.fx, depth_scale=float(cfg.depth_scale),
                                  stereo_baseline=float(cfg.stereo_baseline),
                                  max_disparity=int(cfg.stereo_max_disparity),
                                  threshold=float(self._tracking.fast_threshold), cell=int(self._tracking.grid_cell))
        inten, depth, feats = out[0], out[1], out[2:]
        event = None
        if inten.is_cuda:
            host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in feats)
            for h, t in zip(host, feats):
                h.copy_(t, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            feats = host
        return DetectOut(rows, inten, depth, torch.zeros_like(inten[0]), feats, event)

    def _detect_batch(self, kf_js, device_images, camera, cfg, out: Optional[DetectOut] = None):
        """The keyframes' features from a queued detection (queued here when
        ``out`` is None): waits on its event only. Returns (intensity, depth,
        zeros, features, rows) with rows[bi] the plane row of keyframe bi."""
        if out is None:
            out = self.dispatch_detect(kf_js, device_images, camera, cfg)
        if out.event is not None:
            out.event.synchronize()
        row_of = {j: r for r, j in enumerate(out.rows)}
        sel = np.asarray([row_of[int(j)] for j in kf_js], np.int64)
        feats = tuple(t.numpy()[sel] for t in out.features)
        return out.intensity, out.depth, out.zeros, feats, sel

    def process_chunk(self, buf: List, poses: List[np.ndarray], covs: List[np.ndarray], kf_flags: List[bool],
                      camera: Camera, cfg, device_images: Optional[Tuple] = None,
                      detect_out: Optional[DetectOut] = None) -> Optional[np.ndarray]:
        """Run the keyframe backend over one chunk. Returns a 4x4
        right-composed correction (T_est^-1 . T_corr of the corrected
        keyframe) to fold into the device state, or None.

        ``buf``: the chunk's (t_ns, intensity, depth) items; the images are
        read only without ``device_images``, the scan's staged (K, H, W)
        sensor images on the device. ``detect_out``: the chunk's queued
        detection (`dispatch_detect`)."""
        if self.compute_device.type != "cpu":
            return self._process_chunk(buf, poses, covs, kf_flags, camera, cfg, device_images, detect_out)
        threads = torch.get_num_threads()  # the calling thread's own setting
        torch.set_num_threads(CPU_THREADS)
        try:
            return self._process_chunk(buf, poses, covs, kf_flags, camera, cfg, device_images, detect_out)
        finally:
            torch.set_num_threads(threads)

    def _process_chunk(self, buf, poses, covs, kf_flags, camera, cfg, device_images, detect_out):
        delta: Optional[np.ndarray] = None
        if self._cam_host is None:
            from ..features.tracking import _cam_floats

            self._cam_host = Camera(*(np.float32(c) for c in _cam_floats(camera)))
        kf_js = [j for j, is_kf in enumerate(kf_flags) if bool(is_kf)]
        if not kf_js:
            return None

        batch = None
        if device_images is not None or detect_out is not None:
            try:
                with timer.scope("map.detect_batch"):
                    batch = self._detect_batch(kf_js, device_images, camera, cfg, out=detect_out)
                self.batched_detect_chunks += 1
            except Exception as exc:
                self._log.warning("batched keyframe extraction failed: %s", exc)
                batch = None

        # every keyframe's HostFrame, with the batch's features where it ran
        frames: List[Tuple[HostFrame, np.ndarray]] = []
        for bi, j in enumerate(kf_js):
            t_ns, intensity, depth = buf[j]
            est_pose = np.asarray(poses[j], np.float64)
            if batch is not None:
                inten_b, depth_b, zeros, (uv, _resp, keep, desc, z), plane_rows = batch
                pr = int(plane_rows[bi])
                frame = HostFrame(frame=_light_frame(inten_b[pr], depth_b[pr], zeros, self._cam_host),
                                  t_ns=int(t_ns), pose=est_pose, cov=np.asarray(covs[j]))
                k = keep[bi]
                frame.keypoints = uv[bi][k]
                frame.descriptors = desc[bi][k]
                frame.kp_depth = z[bi][k]
                frame.kp_landmark = np.full(len(frame.keypoints), -1, np.int64)
            else:
                if device_images is not None:
                    inten_j, second_j = device_images[0][j], device_images[1][j]
                else:
                    inten_j, second_j = _upload(intensity, self.device), _upload(depth, self.device)
                inten, dep = _light_arrays(inten_j, second_j, camera.fx, float(cfg.depth_scale),
                                           float(cfg.stereo_baseline), int(cfg.stereo_max_disparity))
                frame = HostFrame(frame=_light_frame(inten, dep, torch.zeros_like(inten), self._cam_host),
                                  t_ns=int(t_ns), pose=est_pose, cov=np.asarray(covs[j]))
            frames.append((frame, est_pose))

        # one match call for the chunk needs the batch's features and no
        # per-keyframe BA in between; else the reference's per-keyframe cadence
        batch_track = batch is not None and self.track_schedule == "chunk" and self.ba_schedule != "keyframe"
        if batch_track:
            try:
                with timer.scope("map.track"):
                    # before the insertion: track_batch rebuilds each
                    # keyframe's window itself and inserts the new landmarks
                    self._tracking.track_batch([f for f, _ in frames], self.map)
                self.batched_track_chunks += 1
            except Exception as exc:
                if getattr(exc, "mutated_map", False):
                    # the write-back began: tracking these frames again would
                    # corrupt the observation graph, so the chunk goes untracked
                    self._log.warning("chunk-batched tracking failed mid-write-back (skipping the chunk's "
                                      "tracking): %s", exc)
                else:
                    self._log.warning("chunk-batched tracking failed: %s", exc)
                    batch_track = False

        last_frame: Optional[HostFrame] = None
        last_est: Optional[np.ndarray] = None
        for frame, est_pose in frames:
            self.map.insert(frame, True)
            last_frame, last_est = frame, est_pose
            try:
                if not batch_track:
                    with timer.scope("map.track"):
                        new_points = self._tracking.track(frame, self.map)
                    self.map.insert_points(new_points)
                    if self.ba_schedule == "keyframe":
                        d = self._run_ba(frame, est_pose)
                        delta = d if d is not None else delta
                if self._graph is not None:
                    with timer.scope("map.graph"):
                        self._graph.add_keyframe(frame)
                        corrections = self._graph.try_close(frame)
                    if corrections and frame.id in corrections:
                        in_window = {f.id for f in self.map.keyframes()} | {f.id for f in self.map.frames()}
                        for fid, T in corrections.items():
                            if fid in in_window:
                                self.map.update_pose(fid, T)
                        # fold online only a significant closure (graph_backend.
                        # try_close); "always" keeps Map::updatePoses semantics
                        if self._graph.last_closure_significant or self.pose_write_back == "always":
                            delta = lie_np.inv(est_pose) @ corrections[frame.id]
            except Exception as exc:  # NodeMapping.cpp:176-178
                self._log.warning("chunk mapping backend failed: %s", exc)
        if self.ba_schedule == "chunk" and last_frame is not None:
            # one windowed solve per chunk, anchored on the newest keyframe
            try:
                d = self._run_ba(last_frame, last_est)
                delta = d if d is not None else delta
            except Exception as exc:
                self._log.warning("chunk BA failed: %s", exc)
        return delta

    def _run_ba(self, frame: HostFrame, est_pose: np.ndarray) -> Optional[np.ndarray]:
        """Windowed BA and the write-back policy. Returns the correction for
        the device chain, or None."""
        if self._ba is None or len(self.map.keyframes()) < 2:
            return None
        from ..ba.bundle_adjustment import write_back

        with timer.scope("map.ba"):
            corrected = write_back(self._ba, self.map, self._graph, frame.id, est_pose, self.pose_write_back,
                                   self.min_correction)
        return None if corrected is None else lie_np.inv(est_pose) @ corrected  # right-composed
