"""Batched multi-sequence odometry: S sequences advanced in lock-step.

Port of `vslam_tpu.parallel.sequences` (the mapping-off, one-device path).
The JAX package vmaps the sequential scan over S sequences; here the
sequence axis S is the leading axis that every tensor of
`odometry.sequential._step` already carries, so one step per frame serves
all S sequences: the whole-level kernel solves S x 2 pairs in one launch
per level, each sequence with its own intrinsics.

All sequences share the frame geometry (H, W) and the `SequentialConfig`;
the intrinsics may differ per sequence (camera leaves of shape (S,)).
Ragged lengths go through the scan's ``live`` mask: a sequence that has
run out passes its state through and re-emits its last pose.

    odo = MultiSequenceOdometry([Camera.create(fx, fy, cx, cy)] * S, cfg, chunk=16)  # on CUDA
    trajectories = odo.run(streams)  # one [(t_ns, world->cam 4x4, cov 6x6), ...] per stream

Per-sequence mapping backends and a mesh of devices are not ported yet and
raise NotImplementedError.
"""

from __future__ import annotations

from typing import Iterable, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..core import se3
from ..core.camera import Camera
from ..core.device import resolve
from ..core.se3 import SE3
from ..odometry.sequential import (
    SequentialConfig,
    SequentialState,
    _upload,
    _init_batched,
    scan_odometry,
)
from ..utils import timer

__all__ = [
    "stack_cameras",
    "init_states",
    "scan_sequences",
    "sharded_scan_sequences",
    "StagedSuiteChunk",
    "MultiSequenceOdometry",
]


def _no_mesh():
    return NotImplementedError(
        "sharding sequences over devices is not ported yet: it comes with torch.distributed "
        "(one process per card)"
    )


class StagedSuiteChunk(NamedTuple):
    """One lock-step (S, K) chunk on the device, in the sensor dtype; K is
    the most frames any sequence has in it, and ``live`` marks each slot
    that holds a frame (None when every slot does)."""

    stamps: List[List[int]]  # per-sequence timestamps (ragged)
    intensity: torch.Tensor  # (S, K, H, W)
    depth: torch.Tensor  # (S, K, H, W): depth counts, or the right stereo image
    dts: torch.Tensor  # (S, K) f32 seconds
    live: object  # (S, K) bool tensor, or None


def _fold_corrections(states: SequentialState, dR: torch.Tensor, dt: torch.Tensor) -> SequentialState:
    """Right-compose per-sequence corrections (S, 3, 3), (S, 3) (identity
    rows for uncorrected sequences) onto the batched pose chain: pose' =
    pose . d, which chains future poses off the corrected keyframe and keeps
    the measured camera-relative motion."""
    d = SE3(dR.to(states.pose_kf.R), dt.to(states.pose_kf.t))
    return states._replace(pose_kf=se3.orthonormalize(se3.compose(states.pose_kf, d)),
                           pose_last=se3.orthonormalize(se3.compose(states.pose_last, d)))


def stack_cameras(cameras: Sequence[Camera]) -> Camera:
    """S per-sequence cameras as one Camera with leaves (S,), on the first
    camera's device where its leaves are tensors, else on CUDA."""
    device = cameras[0].fx.device if torch.is_tensor(cameras[0].fx) else resolve(None)
    return Camera(*(torch.stack([torch.as_tensor(c, dtype=torch.float32, device=device) for c in leaves])
                    for leaves in zip(*cameras)))


def init_states(intensity: torch.Tensor, depth: torch.Tensor, cameras: Camera,
                cfg: SequentialConfig) -> SequentialState:
    """Batched first-frame initialization: (S, H, W) device tensors in a
    sensor dtype, camera leaves (S,). Each sequence's frame 0 is its first
    keyframe (Odometry.cpp:33-35)."""
    return _init_batched(intensity, depth, cameras, cfg)


def scan_sequences(states: SequentialState, intensity, depth, dt, live, cameras: Camera,
                   cfg: SequentialConfig):
    """Advance all S sequences by a K-frame chunk: intensity and depth (S,
    K, H, W), dt and live (S, K) (live None when every slot holds a frame),
    camera leaves (S,). One step per frame for all S. Returns (states,
    poses SE3 (S, K), valid (S, K), cov (S, K, 6, 6), is_kf (S, K));
    nothing waits for the device."""
    states, poses, valid, cov, is_kf = scan_odometry(
        states, intensity.transpose(0, 1), depth.transpose(0, 1), dt.transpose(0, 1),
        None if live is None else live.transpose(0, 1), cameras, cfg)
    return (states, SE3(poses.R.transpose(0, 1), poses.t.transpose(0, 1)), valid.transpose(0, 1),
            cov.transpose(0, 1), is_kf.transpose(0, 1))


def sharded_scan_sequences(mesh, cfg: SequentialConfig, axis: str = "data"):
    """Sequences sharded over several devices: not ported yet."""
    raise _no_mesh()


class MultiSequenceOdometry:
    """Host driver: feed S frame streams, collect S TUM trajectories.

    Lock-step chunking: every dispatch advances all sequences by up to
    ``chunk`` frames; sequences that run out take dead (live False) slots.
    One dispatch and one fetch per chunk cover the whole suite, and each
    chunk's fetch waits until the next chunk is dispatched.
    """

    def __init__(self, cameras: Sequence[Camera], cfg: SequentialConfig = SequentialConfig(),
                 chunk: int = 16, mesh=None, mappings=None):
        """The suite runs on its cameras' device (`stack_cameras`)."""
        if mappings is not None:
            raise NotImplementedError(
                "per-sequence mapping backends are not ported yet: they come with "
                "odometry/sequential_mapping.py, features/ and ba/"
            )
        if mesh is not None:
            raise _no_mesh()
        self.cameras = stack_cameras(list(cameras))
        self.device = self.cameras.fx.device
        self.cfg = cfg
        self.chunk = int(chunk)

    def _read_firsts(self, streams):
        """Each stream's first frame, checked for the shared geometry."""
        its = [iter(s) for s in streams]
        firsts = []
        for s, it in enumerate(its):
            try:
                firsts.append(next(it))
            except StopIteration:
                raise ValueError(f"sequence {s} yielded no frames (empty dataset / bad path?)") from None
        shape = np.asarray(firsts[0][1]).shape
        for s, f in enumerate(firsts):
            if np.asarray(f[1]).shape != shape:
                raise ValueError(
                    f"all sequences must share frame geometry: sequence {s} is "
                    f"{np.asarray(f[1]).shape}, sequence 0 is {shape} (the batched scan "
                    "steps all sequences together)"
                )
        return its, firsts, shape

    def _stage_iter(self, streams):
        """(firsts, lazy iterator of StagedSuiteChunk): `run` pulls one
        lock-step chunk at a time, so a chunk's staging overlaps the
        previous chunk's device work; `stage_streams` exhausts it."""
        its, firsts, (H, W) = self._read_firsts(streams)
        S = len(its)
        idt = np.asarray(firsts[0][1]).dtype
        ddt = np.asarray(firsts[0][2]).dtype

        def gen():
            t_last = [int(f[0]) for f in firsts]
            done = [False] * S
            while not all(done):
                K = self.chunk
                inten = np.zeros((S, K, H, W), idt)
                depth = np.zeros((S, K, H, W), ddt)
                dts = np.zeros((S, K), np.float32)
                live = np.zeros((S, K), bool)
                stamps: List[List[int]] = [[] for _ in range(S)]
                for s in range(S):
                    for j in range(K):
                        if done[s]:
                            break
                        try:
                            t_ns, i_, d_ = next(its[s])
                        except StopIteration:
                            done[s] = True
                            break
                        inten[s, j] = i_
                        depth[s, j] = d_
                        dts[s, j] = (int(t_ns) - t_last[s]) / 1e9
                        live[s, j] = True
                        t_last[s] = int(t_ns)
                        stamps[s].append(int(t_ns))
                n = max(len(st) for st in stamps)
                if n == 0:
                    return
                # a chunk holds only its frames: K is the longest sequence's count
                yield StagedSuiteChunk(
                    stamps=stamps,
                    intensity=_upload(inten[:, :n], self.device),
                    depth=_upload(depth[:, :n], self.device),
                    dts=_upload(dts[:, :n], self.device),
                    live=None if live[:, :n].all() else _upload(live[:, :n], self.device),
                )

        return firsts, gen()

    def run(self, streams: Sequence[Iterable[Tuple[int, np.ndarray, np.ndarray]]]):
        """Returns, per sequence, a list of (t_ns, pose world->cam 4x4 f64,
        cov 6x6 f64): the contract of `SequentialOdometry.run`."""
        firsts, chunk_iter = self._stage_iter(streams)
        return self._run_chunks(firsts, chunk_iter)

    def stage_streams(self, streams):
        """Stage every chunk of the suite on the device up front: (firsts,
        chunks) for `run_staged`, which several replays may share."""
        firsts, chunk_iter = self._stage_iter(streams)
        return firsts, list(chunk_iter)

    def run_staged(self, firsts, chunks: List[StagedSuiteChunk]):
        """Replay staged suite chunks with no image upload: the results of
        `run` on the same streams."""
        return self._run_chunks(firsts, iter(chunks))

    def _run_chunks(self, firsts, chunk_iter):
        with timer.scope("suite.init_states"):
            states = init_states(_upload(np.stack([np.asarray(f[1]) for f in firsts]), self.device),
                                 _upload(np.stack([np.asarray(f[2]) for f in firsts]), self.device),
                                 self.cameras, self.cfg)
        out: List[List[Tuple[int, np.ndarray, np.ndarray]]] = [
            [(int(f[0]), np.eye(4), np.eye(6))] for f in firsts
        ]
        pending = None
        for sc in chunk_iter:
            with timer.scope("suite.dispatch"):
                states, poses, _, cov, _ = scan_sequences(states, sc.intensity, sc.depth, sc.dts, sc.live,
                                                          self.cameras, self.cfg)
            # the previous chunk's fetch waits until this one is queued
            if pending is not None:
                self._collect(out, *pending)
            pending = (sc.stamps, poses, cov)
        if pending is not None:
            self._collect(out, *pending)
        return out

    @staticmethod
    def _collect(out, stamps, poses: SE3, cov: torch.Tensor) -> None:
        """The chunk's one fetch, then f64 poses re-orthonormalized by SVD
        on the host."""
        with timer.scope("suite.collect"):
            S, K = poses.t.shape[:2]
            flat = torch.cat([poses.R.reshape(S, K, 9), poses.t.reshape(S, K, 3), cov.reshape(S, K, 36)],
                             dim=-1).cpu().double().numpy()
        for s, seq_stamps in enumerate(stamps):
            for j, t_ns in enumerate(seq_stamps):
                T = np.eye(4)
                u, _, vt = np.linalg.svd(flat[s, j, :9].reshape(3, 3))
                T[:3, :3] = u @ vt
                T[:3, 3] = flat[s, j, 9:12]
                out[s].append((t_ns, T, flat[s, j, 12:48].reshape(6, 6)))
