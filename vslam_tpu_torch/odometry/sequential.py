"""Sequential odometry: the online tracker's per-frame update, chunked.

Port of `vslam_tpu.odometry.sequential`. Per frame:
pyramid build, motion prediction (NoMotion, ConstantMotion or the SE(3)
EKF), joint alignment against {keyframe, last frame} from their cached
per-level data (`ic.precompute_frame`), speed update and the keyframe
policy (every `kf_period` frames, or a translation from the keyframe above
`kf_max_translation`; KeyFrameSelection.cpp:30-54). The JAX package runs a
chunk of K frames as one `lax.scan` program; here `scan_odometry` is a
Python loop over the K slots whose every step stays on the device: each
branch on a device value (alignment success, keyframe switch, a dead
`live` slot) is a `torch.where` select, so the host waits for the device
once per chunk, in `SequentialOdometry._collect`. Unlike the JAX scan,
whose fixed shapes need a padded final chunk, a chunk here holds only its
frames; the `live` masks of `scan_odometry` serve sequences batched along S
that end at different frames.

`_step` carries a leading sequence axis S on every tensor (S = 1 for one
stream), so batching sequences is a matter of stacking their states
(`parallel.sequences`).

With ``stereo_baseline > 0`` a stream item's second image is the right
image of a rectified pair (uint8) and depth comes from `io.kitti.
stereo_depth` on the device inside the step; ``depth_scale`` does not apply
to it.

    odo = SequentialOdometry(Camera.create(fx, fy, cx, cy), cfg, chunk=32)  # on CUDA
    trajectory = odo.run(stream)  # [(t_ns, world->cam 4x4 f64, cov 6x6), ...]

With ``mapping=`` a `sequential_mapping.ChunkMappingBackend` runs full SLAM
between chunks (the JAX package's `sequential.py:344-694`). With ``viz=`` a
`viz.LiveViz` gets each retired chunk's poses, covariances and keyframes
from the host arrays of the chunk's one fetch, and the backend map's
landmarks as the thread that writes the map reads them; it adds no wait
for the device and no launch.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..alignment import ic
from ..alignment.ic import AlignmentConfig
from ..core import se3
from ..core.camera import Camera
from ..core.device import resolve
from ..core.frame import create_frame
from ..core.se3 import SE3
from ..kalman import ekf_se3
from ..utils import timer
from ..utils.log import get_logger
from ..utils.tree import tree_map

__all__ = [
    "SequentialConfig",
    "SequentialState",
    "StagedChunk",
    "init_state",
    "scan_odometry",
    "stage_stream",
    "SequentialOdometry",
]


@dataclasses.dataclass(frozen=True)
class SequentialConfig:
    """Same fields and defaults as `vslam_tpu.odometry.sequential.SequentialConfig`."""

    alignment: AlignmentConfig = AlignmentConfig()
    # metres = raw * depth_scale: frames travel in their sensor dtype (uint8
    # intensity, uint16 depth at 1/5000 m for TUM) and widen on the device
    depth_scale: float = 1.0
    stereo_baseline: float = 0.0  # > 0: the second image is the right one of a stereo pair
    stereo_max_disparity: int = 96
    n_levels: int = 3
    prediction_model: str = "ConstantMotion"  # NoMotion | ConstantMotion | Kalman
    ekf_process_noise: float = 1e-2
    ekf_measurement_noise: float = 1e-2
    kf_period: int = 5  # keyframe_selection.idx.period
    kf_max_translation: float = 0.2  # KeyFrameSelectionCustom translation trigger
    include_key_frame: bool = True  # align {kf, last} jointly (Odometry.cpp:36)


class SequentialState(NamedTuple):
    """Device state between frames; every leaf has a leading axis S."""

    kf_data: Tuple[ic.ICLevelData, ...]  # cached precompute of the keyframe
    last_data: Tuple[ic.ICLevelData, ...]  # ... and of the last frame
    pose_kf: SE3  # world -> cam
    pose_last: SE3
    speed: torch.Tensor  # (S, 6) twist / s
    kf_ctr: torch.Tensor  # (S,) int32 frames since the keyframe
    ekf: ekf_se3.EkfState  # used when prediction_model == "Kalman"


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array to the device in its sensor dtype. 16-bit unsigned
    depth travels as int16 bits (torch has few uint16 kernels) and
    `_sensor_f32` widens it as unsigned on the device."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    t = torch.from_numpy(a)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _sensor_f32(x: torch.Tensor) -> torch.Tensor:
    """Widen a sensor image to f32 on its device; int16 holds the bits of
    unsigned 16-bit depth counts (see `_upload`)."""
    if x.dtype == torch.int16:
        return (x.to(torch.int32) & 0xFFFF).to(torch.float32)
    return x.to(torch.float32)


def _device_camera(camera: Camera, device) -> Camera:
    return Camera(*(torch.as_tensor(c, dtype=torch.float32, device=device) for c in camera))


def _sensor_frame(intensity: torch.Tensor, second: torch.Tensor, camera: Camera,
                  cfg: SequentialConfig):
    """(S, H, W) sensor images on the device -> the current frame's pyramid.
    ``second`` is depth counts, or with ``stereo_baseline > 0`` the right
    image, block-matched against the left with each sequence's fx. The
    span "frame.build"."""
    with timer.scope("frame.build"):
        intensity = _sensor_f32(intensity)
        if cfg.stereo_baseline > 0.0:
            from ..io.kitti import stereo_depth

            depth = stereo_depth(intensity, _sensor_f32(second), camera.fx, cfg.stereo_baseline,
                                 max_disparity=cfg.stereo_max_disparity)
        else:
            depth = _sensor_f32(second) * cfg.depth_scale
        return create_frame(intensity, depth, camera, n_levels=cfg.n_levels)


def init_state(intensity: np.ndarray, depth: np.ndarray, camera: Camera,
               cfg: SequentialConfig) -> SequentialState:
    """The first frame (H, W host arrays in a sensor dtype) starts the pose
    chain at the identity and is the first keyframe (Odometry.cpp:33-35).
    The state, with S = 1, lives on the camera's device."""
    device = camera.fx.device
    return _init_batched(_upload(intensity, device)[None], _upload(depth, device)[None],
                         _device_camera(camera, device), cfg)


def _init_batched(intensity: torch.Tensor, depth: torch.Tensor, camera: Camera,
                  cfg: SequentialConfig) -> SequentialState:
    """`init_state` for S first frames at once: (S, H, W) device tensors in
    a sensor dtype, camera leaves () or (S,) on the same device."""
    S, device = intensity.shape[0], intensity.device
    data = ic.precompute_frame(_sensor_frame(intensity, depth, camera, cfg), cfg.alignment)
    pose = se3.identity((S,), device=device)
    return SequentialState(
        kf_data=data,
        last_data=data,
        pose_kf=pose,
        pose_last=pose,
        speed=torch.zeros(S, 6, device=device),
        kf_ctr=torch.zeros(S, dtype=torch.int32, device=device),
        ekf=ekf_se3.init(pose=pose, process_noise=cfg.ekf_process_noise),
    )


def _select(pred: torch.Tensor, a, b):
    """Leaf-wise where(pred, a, b), pred (S,) broadcast over each leaf."""
    return tree_map(lambda u, v: torch.where(pred.view(-1, *([1] * (u.dim() - 1))), u, v), a, b)


class StagedChunk(NamedTuple):
    """One chunk of the stream on the device, in the sensor dtype."""

    stamps: Tuple[int, ...]
    intensity: torch.Tensor  # (K, H, W)
    depth: torch.Tensor  # (K, H, W)
    dts: torch.Tensor  # (K,) f32 seconds since the previous frame


def _stage_chunk(buf, t_prev_ns: int, device) -> StagedChunk:
    """Stack a chunk's frames into (K, H, W) arrays and copy them to the
    device: the only host-to-device image transfer of the path."""
    stamps = [int(t_ns) for t_ns, _, _ in buf]
    dts = (np.diff(np.asarray([int(t_prev_ns)] + stamps)) / 1e9).astype(np.float32)
    return StagedChunk(
        stamps=tuple(stamps),
        intensity=_upload(np.stack([i for _, i, _ in buf]), device),
        depth=_upload(np.stack([d for _, _, d in buf]), device),
        dts=_upload(dts, device),
    )


def stage_stream(
    stream: Iterable[Tuple[int, np.ndarray, np.ndarray]], chunk: int, device=None
) -> Tuple[Tuple[int, np.ndarray, np.ndarray], List[StagedChunk]]:
    """Stage a whole stream on ``device`` (CUDA unless named) up front:
    returns the first frame (for `init_state`) and the rest as
    `StagedChunk`s for `SequentialOdometry.run_staged`, which several
    replays may share."""
    device = resolve(device)
    it = iter(stream)
    try:
        first = next(it)
    except StopIteration:
        raise ValueError("stream yielded no frames (empty dataset / bad path?)") from None
    t_prev = int(first[0])
    chunks: List[StagedChunk] = []
    buf: List[Tuple[int, np.ndarray, np.ndarray]] = []
    for item in it:
        buf.append(item)
        if len(buf) == chunk:
            chunks.append(_stage_chunk(buf, t_prev, device))
            t_prev = chunks[-1].stamps[-1]
            buf = []
    if buf:
        chunks.append(_stage_chunk(buf, t_prev, device))
    return first, chunks


def _step(state: SequentialState, intensity, depth, dt, live, camera: Camera,
          cfg: SequentialConfig):
    """One odometry update for S sequences: images (S, H, W) in the sensor
    dtype, dt and live (S,). A dead slot passes the state through and
    re-emits the last pose; live None means every slot is live, and skips
    the selects. Returns (state, (pose (S,), valid (S,), cov (S, 6, 6),
    is_kf (S,)))."""
    cur = _sensor_frame(intensity, depth, camera, cfg)

    if cfg.prediction_model == "Kalman":
        # EKF predict (MotionPrediction.cpp:57-81)
        ekf_pred, pred_pose = ekf_se3.predict(state.ekf, dt)
        pred_pose = se3.orthonormalize(pred_pose)
    elif cfg.prediction_model == "NoMotion":
        ekf_pred, pred_pose = state.ekf, state.pose_last
    else:
        # constant motion (MotionPrediction.cpp:49-55)
        ekf_pred = state.ekf
        pred_pose = se3.compose(se3.exp(state.speed * dt[:, None]), state.pose_last)

    # the current frame's precompute, once: the last frame's data next step,
    # and the keyframe's after a switch
    cur_data = ic.precompute_frame(cur, cfg.alignment)
    rel_l = se3.compose(pred_pose, se3.inverse(state.pose_last))
    if cfg.include_key_frame:
        ref_data = tuple(tree_map(lambda a, b: torch.stack([a, b], dim=1), kd, ld)
                         for kd, ld in zip(state.kf_data, state.last_data))
        rel_k = se3.compose(pred_pose, se3.inverse(state.pose_kf))
        rel_init = SE3(torch.stack([rel_k.R, rel_l.R], 1), torch.stack([rel_k.t, rel_l.t], 1))
        x_pred = torch.stack([se3.log(rel_k), se3.log(rel_l)], 1)
        pose_ref0 = state.pose_kf
    else:
        ref_data = tuple(tree_map(lambda a: a[:, None], ld) for ld in state.last_data)
        rel_init = SE3(rel_l.R[:, None], rel_l.t[:, None])
        x_pred = se3.log(rel_l)[:, None]
        pose_ref0 = state.pose_last

    rel, cov, ok = ic.align(None, cur, rel_init, x_pred, cfg.alignment, ref_data=ref_data)
    pose_aligned = se3.orthonormalize(se3.compose(SE3(rel.R[:, 0], rel.t[:, 0]), pose_ref0))
    pose_new = _select(ok, pose_aligned, pred_pose)

    # speed = log(last -> new) / dt; zero on failure or dt <= 0 (Odometry.cpp:44-56)
    rel_last = se3.compose(pose_new, se3.inverse(state.pose_last))
    v_meas = se3.log(rel_last) / torch.clamp(dt, min=1e-6)[:, None]
    speed_new = torch.where((ok & (dt > 0))[:, None], v_meas, torch.zeros_like(v_meas))

    if cfg.prediction_model == "Kalman":
        # re-anchor the filter at the odometry pose, then the velocity
        # update with R from the aligner's covariance
        anchored = ekf_pred._replace(pose=pose_new)
        R = ekf_se3.measurement_noise_from_cov(cov, scale=cfg.ekf_measurement_noise)
        ekf_new = _select(dt > 0, ekf_se3.update(anchored, v_meas, R), anchored)
    else:
        ekf_new = state.ekf

    ctr = state.kf_ctr + 1
    rel_kf = se3.compose(pose_new, se3.inverse(state.pose_kf))
    is_kf = (ctr >= cfg.kf_period) | (torch.linalg.vector_norm(rel_kf.t, dim=-1) > cfg.kf_max_translation)

    new_state = SequentialState(
        kf_data=_select(is_kf, cur_data, state.kf_data),
        last_data=cur_data,
        pose_kf=_select(is_kf, pose_new, state.pose_kf),
        pose_last=pose_new,
        speed=speed_new,
        kf_ctr=torch.where(is_kf, torch.zeros_like(ctr), ctr).to(torch.int32),
        ekf=ekf_new,
    )
    if live is None:
        return new_state, (pose_new, ok, cov, is_kf)
    new_state = _select(live, new_state, state)
    pose_out = _select(live, pose_new, state.pose_last)
    return new_state, (pose_out, ok & live, cov, is_kf & live)


def scan_odometry(state: SequentialState, intensity, depth, dt, live, camera: Camera,
                  cfg: SequentialConfig):
    """Run a chunk of K frames: intensity and depth (K, S, H, W), dt and
    live (K, S), or live None when every slot is live. Returns (state,
    poses SE3 (K, S), valid (K, S), cov (K, S, 6, 6), is_kf (K, S));
    nothing waits for the device. Each step is a span "scan.step"."""
    outs = []
    for k in range(intensity.shape[0]):
        with timer.scope("scan.step"):
            state, out = _step(state, intensity[k], depth[k], dt[k],
                               None if live is None else live[k], camera, cfg)
        outs.append(out)
    poses = SE3(torch.stack([o[0].R for o in outs]), torch.stack([o[0].t for o in outs]))
    valid, cov, is_kf = (torch.stack([o[i] for o in outs]) for i in (1, 2, 3))
    return state, poses, valid, cov, is_kf


class SequentialOdometry:
    """Host driver: feed (t_ns, intensity, depth) frames, collect a TUM
    trajectory. One chunk dispatch and one fetch per chunk; the frames
    run on the camera's device.

    ``mapping``: a `sequential_mapping.ChunkMappingBackend`, handed every
    retired chunk (its keyframes, poses and staged images). With
    ``async_mapping`` it runs on one worker thread beside the next chunks'
    scans, and a correction measured on chunk k folds into the device
    chain at chunk k + ``backend_depth``'s retire, a fixed point, so runs
    repeat exactly; the worker re-bases each chunk's poses by the
    corrections it has returned (`_worker_job`). Without it, each
    correction folds before the next chunk is dispatched (the reference's
    cadence).

    ``viz``: a `viz.LiveViz` fed each retired chunk (the seed frame as the
    first keyframe), and the map's landmarks after each backend job."""

    def __init__(self, camera: Camera, cfg: SequentialConfig = SequentialConfig(), chunk: int = 16,
                 mapping=None, async_mapping: bool = True, backend_depth: int = 2, viz=None):
        self.viz = viz
        self.device = camera.fx.device
        self.camera = _device_camera(camera, self.device)
        self.cfg = cfg
        self.chunk = int(chunk)
        self.mapping = mapping
        self.async_mapping = bool(async_mapping) and mapping is not None
        self.backend_depth = max(1, int(backend_depth))
        self._backend_futures: List = []
        # the cumulative correction as the worker sees it (every delta its
        # jobs returned, folded into the device chain or not); only the
        # worker thread touches it while a run is going
        self._C_worker: np.ndarray = np.eye(4)
        self._executor = None
        if self.async_mapping:
            import concurrent.futures

            self._executor = concurrent.futures.ThreadPoolExecutor(max_workers=1,
                                                                   thread_name_prefix="mapping-backend")
        self.state: Optional[SequentialState] = None
        self._t_last_ns: Optional[int] = None
        # the cumulative right-composed correction folded into the device
        # chain; a chunk records it at dispatch, and re-basing its poses
        # appends inv(C_at_dispatch) @ C_now
        self._C_total: np.ndarray = np.eye(4)
        # per returned frame: alignment valid, keyframe (the first frame is
        # the first keyframe)
        self.valid: List[bool] = []
        self.is_kf: List[bool] = []

    def _start(self, first, out) -> None:
        t_ns, i0, d0 = first
        with timer.scope("seq.init_state"):
            self.state = init_state(i0, d0, self.camera, self.cfg)
        self._t_last_ns = int(t_ns)
        out.append((int(t_ns), np.eye(4), np.eye(6)))
        self.valid.append(True)
        self.is_kf.append(True)
        if self.viz is not None:  # the seed frame is the first keyframe
            self.viz.publish_odometry(int(t_ns), np.eye(4), cov=np.eye(6))
            self.viz.publish_keyframe(int(t_ns), np.eye(4))
        if self.mapping is not None:
            # the first frame is the backend's first keyframe
            with timer.scope("seq.first_frame_backend"):
                self.mapping.process_chunk([(int(t_ns), i0, d0)], [np.eye(4)], [np.eye(6)], [True],
                                           self.camera, self.cfg)

    def _join_stale_futures(self) -> None:
        """Finish the worker jobs a prior aborted run left in flight (they
        change the map and `_C_worker`), logging their errors: that run's
        caller never saw them."""
        while self._backend_futures:
            try:
                self._backend_futures.pop(0).result()
            except Exception as exc:
                get_logger("sequential").warning("stale backend job from an aborted prior run failed: %s", exc)

    def _apply_correction(self, delta: np.ndarray) -> None:
        """Right-compose a BA or loop-closure correction onto the device
        chain before the next chunk: pose' = pose . delta, delta = T_est^-1 .
        T_corr of the corrected keyframe. Future poses chain off the
        corrected keyframe and every measured camera-relative motion is
        kept (the correction pivots at the corrected camera)."""
        d = SE3(torch.as_tensor(delta[:3, :3], dtype=torch.float32, device=self.device),
                torch.as_tensor(delta[:3, 3], dtype=torch.float32, device=self.device))
        self.state = self.state._replace(pose_kf=se3.orthonormalize(se3.compose(self.state.pose_kf, d)),
                                         pose_last=se3.orthonormalize(se3.compose(self.state.pose_last, d)))
        self._C_total = self._C_total @ np.asarray(delta, np.float64)

    def run(self, stream: Iterable[Tuple[int, np.ndarray, np.ndarray]]):
        """Returns [(t_ns, pose world->cam 4x4 f64, cov 6x6 f64), ...]. Each
        chunk is staged and dispatched before the previous one is fetched,
        so its upload and launches overlap the previous chunk's device work
        (with synchronous mapping the previous chunk retires first). A
        second call continues the trajectory."""
        self._join_stale_futures()
        out: List[Tuple[int, np.ndarray, np.ndarray]] = []
        buf: List[Tuple[int, np.ndarray, np.ndarray]] = []
        pending = None
        for item in stream:
            if self.state is None:
                self._start(item, out)
                continue
            buf.append(item)
            if len(buf) == self.chunk:
                pending = self._advance(_stage_chunk(buf, self._t_last_ns, self.device), pending, out)
                buf = []
        if buf:
            pending = self._advance(_stage_chunk(buf, self._t_last_ns, self.device), pending, out)
        if pending is not None:
            self._retire(pending, out)
        if self.async_mapping:
            self._drain_backend()  # the last correction reaches the device state
        return out

    def run_staged(self, first, chunks: List[StagedChunk]):
        """Replay a stream staged by `stage_stream` on this device: the same
        results as `run` on the same frames and chunking, with no image
        upload. Starts a fresh trajectory from `first`; in mapping mode give
        each replay a fresh backend (the map is the backend's state)."""
        self._join_stale_futures()
        self.valid, self.is_kf = [], []
        self._C_total = np.eye(4)
        self._C_worker = np.eye(4)
        out: List[Tuple[int, np.ndarray, np.ndarray]] = []
        self._start(first, out)
        pending = None
        for sc in chunks:
            pending = self._advance(sc, pending, out)
        if pending is not None:
            self._retire(pending, out)
        if self.async_mapping:
            self._drain_backend()
        return out

    def _advance(self, sc: StagedChunk, pending, out):
        """Dispatch a staged chunk (every slot live: chunks are not padded),
        then retire the previous one, which waits for the device while this
        chunk's scan runs. Synchronous mapping retires first, so the
        backend's correction is in the state this chunk is solved from."""
        if self.mapping is not None and not self.async_mapping and pending is not None:
            self._retire(pending, out)
            pending = None
        with timer.scope("seq.dispatch"):
            self.state, poses, valid, cov, is_kf = scan_odometry(
                self.state, sc.intensity[:, None], sc.depth[:, None], sc.dts[:, None],
                None, self.camera, self.cfg,
            )
            detect = self._dispatch_detect_early(sc)
        self._t_last_ns = sc.stamps[-1]
        rec = (sc, poses, valid, cov, is_kf, self._C_total.copy(), detect)
        if pending is not None:
            self._retire(pending, out)
        return rec

    def _dispatch_detect_early(self, sc: StagedChunk):
        """Mapping mode: queue the feature extraction of all the chunk's
        frames right behind its scan (the keyframe flags are not known yet;
        queued any later, it would wait behind the next scan). Stereo
        extracts the keyframes only, at the retire, so that block matching
        does not run again on every frame."""
        if self.mapping is None or self.cfg.stereo_baseline != 0.0:
            return None
        try:
            return self.mapping.dispatch_detect(None, (sc.intensity, sc.depth), self.camera, self.cfg)
        except Exception as exc:
            get_logger("sequential").warning("early detect dispatch failed (the retire queues it): %s", exc)
            return None

    def _retire(self, rec, out) -> None:
        """Fetch a dispatched chunk's results into the trajectory (odometry
        estimates; corrections shape the future chain), then hand the chunk
        to the mapping backend."""
        sc, poses, valid, cov, is_kf, C_dispatch, detect = rec
        results, kf_flags = self._collect(sc.stamps, poses, valid, cov, is_kf, out)
        if self.viz is not None:
            with timer.scope("viz.publish"):
                for (t, T, c), kf in zip(results, kf_flags):
                    self.viz.publish_odometry(t, T, cov=c)
                    if kf:
                        self.viz.publish_keyframe(t, T)
        if self.mapping is None:
            return
        images = (sc.intensity, sc.depth)
        if detect is None:
            # stereo, or a failed early dispatch: queue the keyframes'
            # extraction here, on this thread, so that the worker launches nothing
            kf_js = [j for j, k in enumerate(kf_flags) if k]
            if kf_js:
                try:
                    detect = self.mapping.dispatch_detect(kf_js, images, self.camera, self.cfg)
                except Exception as exc:
                    get_logger("sequential").warning("keyframe detect dispatch failed: %s", exc)
        kwargs = {"device_images": images}
        if detect is not None:
            kwargs["detect_out"] = detect
        # the backend reads the chunk's images from the device
        buf = [(t, None, None) for t in sc.stamps]
        args = (buf, [r[1] for r in results], [r[2] for r in results], kf_flags, self.camera, self.cfg)
        if self.async_mapping:
            self._backend_futures.append(self._executor.submit(self._worker_job, args, kwargs, C_dispatch))
            # a bounded, deterministic lag: block on the oldest job only
            # once more than backend_depth are outstanding
            while len(self._backend_futures) > self.backend_depth:
                self._drain_oldest()
        else:
            delta = self.mapping.process_chunk(*args, **kwargs)
            self._publish_landmarks(self._landmark_positions())
            if delta is not None:
                self._apply_correction(delta)

    def _landmark_positions(self) -> Optional[np.ndarray]:
        """The backend map's landmark positions (N, 3) for the viewer, or
        None (no viewer, or no landmark yet). Called by the thread that
        writes the map, between its writes."""
        if self.viz is None:
            return None
        pts = [p.position for p in self.mapping.map.points()]
        return np.stack(pts) if pts else None

    def _publish_landmarks(self, positions: Optional[np.ndarray]) -> None:
        if positions is not None:
            with timer.scope("viz.publish"):
                self.viz.publish_landmarks(positions)

    def _worker_job(self, args, kwargs, C_dispatch):
        """A backend job on the worker thread (jobs run in chunk order).
        Corrections of earlier jobs may not have reached the device chain
        yet; the chunk's poses carried C_dispatch, the worker's belief is
        C_worker, so they are re-based by inv(C_dispatch) . C_worker and BA
        never measures drift that is still on its way. Returns the
        correction and, for the viewer, the map's landmark positions as the
        job left them."""
        buf, est_poses, covs, kf_flags, camera, cfg = args
        rebase = np.linalg.inv(C_dispatch) @ self._C_worker
        if not np.allclose(rebase, np.eye(4), atol=1e-12):
            est_poses = [p @ rebase for p in est_poses]
        delta = self.mapping.process_chunk(buf, est_poses, covs, kf_flags, camera, cfg, **kwargs)
        if delta is not None:
            self._C_worker = self._C_worker @ np.asarray(delta, np.float64)
        return delta, self._landmark_positions()

    def _drain_oldest(self) -> None:
        """Wait for the oldest backend job and fold its correction into the
        device chain (in chunk order, each once); the viewer gets the map's
        landmarks as that job left them."""
        fut = self._backend_futures.pop(0)
        with timer.scope("seq.drain_backend"):
            delta, landmarks = fut.result()
        self._publish_landmarks(landmarks)
        if delta is not None:
            self._apply_correction(delta)

    def _drain_backend(self) -> None:
        """Finish every outstanding backend job (the end of a stream)."""
        while self._backend_futures:
            self._drain_oldest()

    def _collect(self, stamps, poses, valid, cov, is_kf, out):
        """The chunk's one fetch (the host waits for the device here), then
        f64 poses re-orthonormalized by SVD on the host. Returns the chunk's
        results and keyframe flags."""
        K = len(stamps)
        with timer.scope("seq.collect"):
            flat = torch.cat([poses.R.reshape(K, 9), poses.t.reshape(K, 3), cov.reshape(K, 36),
                              valid.reshape(K, 1).float(), is_kf.reshape(K, 1).float()], dim=1)
            flat = flat.cpu().double().numpy()
        results, kf_flags = [], []
        for j in range(K):
            T = np.eye(4)
            u, _, vt = np.linalg.svd(flat[j, :9].reshape(3, 3))
            T[:3, :3] = u @ vt
            T[:3, 3] = flat[j, 9:12]
            results.append((stamps[j], T, flat[j, 12:48].reshape(6, 6)))
            self.valid.append(bool(flat[j, 48]))
            kf_flags.append(bool(flat[j, 49]))
        self.is_kf.extend(kf_flags)
        out.extend(results)
        return results, kf_flags
