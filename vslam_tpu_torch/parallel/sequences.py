"""Batched multi-sequence odometry: S sequences advanced in lock-step.

Port of `vslam_tpu.parallel.sequences` (the one-device path).
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

With ``mappings=`` each sequence has its own `ChunkMappingBackend` (full
SLAM per sequence, the JAX package's `sequences.py:170-200, 336-470`).

With ``mesh=`` (a 1-D `DeviceMesh` of ranks, `batched.make_mesh`, one
process a GPU) the S sequences are split into equal blocks over the mesh's
"data" axis: every rank is given all S cameras and streams, reads and
scans only its block's, and at the end of the run one `all_gather_object`
hands every rank all S trajectories. Each chunk's only collective is the
reduce of its global valid fraction (`sharded_scan_sequences`).
"""

from __future__ import annotations

import itertools
from typing import Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

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
from ..utils.log import get_logger
from . import mesh as mesh_lib

__all__ = [
    "stack_cameras",
    "init_states",
    "scan_sequences",
    "sharded_scan_sequences",
    "StagedSuiteChunk",
    "MultiSequenceOdometry",
]


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


def stack_cameras(cameras: Sequence[Camera], device=None) -> Camera:
    """S per-sequence cameras as one Camera with leaves (S,), on ``device``
    where named, else on the first camera's device where its leaves are
    tensors, else on CUDA."""
    if device is None:
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


def _valid_counts(valid: torch.Tensor, live):
    """(valid live slots, live slots) of a chunk, as tensors on its device."""
    if live is None:
        return valid.sum(), torch.full((), valid.numel(), device=valid.device)
    return (valid & live).sum(), live.sum()


def sharded_scan_sequences(mesh, cfg: SequentialConfig, axis: str = "data"):
    """The chunk step over sequences sharded on ``axis``: a callable
    ``(states, intensity, depth, dt, live, cameras)`` on this rank's block
    of the S sequences (`scan_sequences`' arguments) returning ``(states,
    poses, valid, cov, is_kf, frac)``. ``frac``, the chunk's tracking
    health, is Σ(valid & live) / Σ max(live count, 1) over the whole mesh
    from one `all_reduce`, the same on every rank: each rank clamps its own
    live count before the sum, as the JAX function does."""
    mesh_lib.axis_index(mesh, axis)

    def step(states, intensity, depth, dt, live, cameras):
        states, poses, valid, cov, is_kf = scan_sequences(states, intensity, depth, dt, live, cameras, cfg)
        n_ok, n = _valid_counts(valid, live)
        frac = mesh_lib.global_fraction(n_ok, n.clamp(min=1), mesh, (axis,))
        return states, poses, valid, cov, is_kf, frac

    return step


class MultiSequenceOdometry:
    """Host driver: feed S frame streams, collect S TUM trajectories.

    Lock-step chunking: every dispatch advances all sequences by up to
    ``chunk`` frames; sequences that run out take dead (live False) slots.
    One dispatch and one fetch per chunk cover the whole suite, and each
    chunk's fetch waits until the next chunk is dispatched.
    """

    def __init__(self, cameras: Sequence[Camera], cfg: SequentialConfig = SequentialConfig(),
                 chunk: int = 16, mesh=None, mappings=None, async_mapping: bool = True):
        """The suite runs on its cameras' device (`stack_cameras`).
        ``mappings``: one `sequential_mapping.ChunkMappingBackend` per
        sequence, each with its own map; its corrections fold into that
        sequence's row of the batched chain. With ``async_mapping`` the
        backends run on a small thread pool beside the next chunk's scan
        and their corrections fold one chunk later, deterministically (the
        contract of `SequentialOdometry(async_mapping=True)`). ``mesh``: a
        1-D `DeviceMesh` with its axis named "data" (`batched.make_mesh`);
        S must split into equal blocks over it, and the block runs on the
        rank's device. ``fracs`` then holds each chunk's global valid
        fraction of the last run, by a rule of its own (the JAX driver
        discards the value): Σ valid live slots / max(Σ live slots, 1) over
        the mesh, so a rank with no live slot adds nothing to the
        denominator, unlike `sharded_scan_sequences`' ``frac``."""
        cameras = list(cameras)
        self.mesh = mesh
        self._block = range(len(cameras))  # the sequences this process runs
        device = None
        if mesh is not None:
            if mesh.ndim != 1:
                raise ValueError(f"the suite shards over a 1-D mesh, got {mesh.ndim} axes")
            index, count = mesh_lib.axis_index(mesh, "data"), mesh_lib.axis_size(mesh, "data")
            if len(cameras) % count:
                raise ValueError(f"{len(cameras)} sequences do not split into {count} equal blocks over the mesh")
            n = len(cameras) // count
            self._block = range(index * n, (index + 1) * n)
            device = mesh_lib.mesh_device(mesh)
        self.cameras = stack_cameras(cameras[self._block.start:self._block.stop], device)
        self.device = self.cameras.fx.device
        self.cfg = cfg
        self.chunk = int(chunk)
        self.mappings = list(mappings) if mappings is not None else None
        if self.mappings is not None and len(self.mappings) != len(cameras):
            raise ValueError("need one mapping backend per sequence")
        # with a mesh a rank drives its block's backends only; the other
        # entries of `mappings` stay untouched in this process
        self._mappings = None if mappings is None else self.mappings[self._block.start:self._block.stop]
        self.async_mapping = bool(async_mapping) and self.mappings is not None
        self.fracs: List[float] = []
        self._backend_futures = None
        self._executor = None
        if self.async_mapping:
            import concurrent.futures

            self._executor = concurrent.futures.ThreadPoolExecutor(max_workers=min(len(self._mappings), 4),
                                                                   thread_name_prefix="suite-mapping")

    def _camera(self, s: int) -> Camera:
        """Sequence s's camera, leaves () on the suite's device."""
        return Camera(*(leaf[s] for leaf in self.cameras))

    def _read_firsts(self, streams):
        """The first frame of each stream of this process's block, checked
        for the shared geometry. The other streams are not read."""
        first = self._block.start
        its = [iter(s) for s in list(streams)[first:self._block.stop]]
        firsts = []
        for s, it in enumerate(its):
            try:
                firsts.append(next(it))
            except StopIteration:
                raise ValueError(f"sequence {first + s} yielded no frames (empty dataset / bad path?)") from None
        shape = np.asarray(firsts[0][1]).shape
        for s, f in enumerate(firsts):
            if np.asarray(f[1]).shape != shape:
                raise ValueError(
                    f"all sequences must share frame geometry: sequence {first + s} is "
                    f"{np.asarray(f[1]).shape}, sequence {first} is {shape} (the batched scan "
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
        cov 6x6 f64): the contract of `SequentialOdometry.run`. With a mesh
        every rank returns all S sequences."""
        firsts, chunk_iter = self._stage_iter(streams)
        return self._run_chunks(firsts, chunk_iter)

    def stage_streams(self, streams):
        """Stage every chunk of the suite on the device up front: (firsts,
        chunks) for `run_staged`, which several replays may share. With a
        mesh only this rank's block is staged."""
        firsts, chunk_iter = self._stage_iter(streams)
        return firsts, list(chunk_iter)

    def run_staged(self, firsts, chunks: List[StagedSuiteChunk]):
        """Replay staged suite chunks with no image upload: the results of
        `run` on the same streams."""
        return self._run_chunks(firsts, iter(chunks))

    def _run_chunks(self, firsts, chunk_iter):
        if self._backend_futures:
            # jobs an aborted run left in flight: finish them (they change
            # the maps) without folding their corrections into this run
            for s, fut in self._backend_futures:
                try:
                    fut.result()
                except Exception as exc:
                    get_logger("sequential").warning(
                        "stale backend job of sequence %d from an aborted prior run failed: %s", s, exc)
            self._backend_futures = None
        with timer.scope("suite.init_states"):
            i0 = np.stack([np.asarray(f[1]) for f in firsts])
            d0 = np.stack([np.asarray(f[2]) for f in firsts])
            states = init_states(_upload(i0, self.device), _upload(d0, self.device), self.cameras, self.cfg)
        out: List[List[Tuple[int, np.ndarray, np.ndarray]]] = [
            [(int(f[0]), np.eye(4), np.eye(6))] for f in firsts
        ]
        if self._mappings is not None:
            # each sequence's frame 0 is its backend's first keyframe
            for s, backend in enumerate(self._mappings):
                backend.process_chunk([(int(firsts[s][0]), i0[s], d0[s])], [np.eye(4)], [np.eye(6)], [True],
                                      self._camera(s), self.cfg)
        pending = None
        self.fracs = []
        if self.mesh is not None:
            # a rank whose streams have run out joins each chunk's reduce
            # (with None) until no rank has frames left
            chunk_iter = itertools.chain(chunk_iter, itertools.repeat(None))
        for sc in chunk_iter:
            if sc is not None:
                with timer.scope("suite.dispatch"):
                    states, poses, valid, cov, is_kf = scan_sequences(states, sc.intensity, sc.depth, sc.dts,
                                                                      sc.live, self.cameras, self.cfg)
            if self.mesh is not None and not self._reduce_chunk(None if sc is None else (valid, sc.live)):
                break
            if sc is None:
                continue
            if self._mappings is not None:
                prev_deltas = {}
                if self.async_mapping:
                    # fold chunk k-1's corrections while the device solves chunk k
                    states, prev_deltas = self._drain_backends(states)
                kf_rows, results = self._collect(out, sc.stamps, poses, cov, is_kf)
                for s, d in prev_deltas.items():
                    # chunk k was solved before chunk k-1's correction
                    # landed: re-base the poses its backend sees, so that BA
                    # does not measure the same drift again
                    results[s] = [(t, T @ d, c) for (t, T, c) in results[s]]
                if self.async_mapping:
                    self._backend_futures = self._submit_backends(kf_rows, results, sc)
                else:
                    states = self._run_backends(states, kf_rows, results, sc)
                continue
            # the previous chunk's fetch waits until this one is queued
            if pending is not None:
                self._collect(out, *pending)
            pending = (sc.stamps, poses, cov)
        if pending is not None:
            self._collect(out, *pending)
        if self.async_mapping:
            self._drain_backends(states)  # surface errors, finish the maps
        return out if self.mesh is None else self._gather(out)

    def _reduce_chunk(self, counted) -> bool:
        """The chunk's one collective: (valid live slots, live slots, ranks
        with frames) summed over the mesh; ``counted`` is (valid, live) of
        this rank's chunk, or None where its streams have run out. Appends
        the global valid fraction to ``fracs``; False once no rank had a
        frame in the chunk."""
        with timer.scope("suite.reduce"):
            if counted is None:
                counts = torch.zeros(3, device=self.device)
            else:
                n_ok, n = _valid_counts(*counted)
                counts = torch.stack((n_ok.float(), n.float(), torch.ones((), device=self.device)))
            n_ok, n, ranks = mesh_lib.all_reduce_sum(counts, self.mesh, ("data",)).tolist()
        if ranks == 0:
            return False
        self.fracs.append(n_ok / max(n, 1.0))
        return True

    def _gather(self, out):
        """Every rank's trajectories in mesh order, on every rank."""
        parts = [None] * mesh_lib.axis_size(self.mesh, "data")
        dist.all_gather_object(parts, (self._block.start, out), group=self.mesh.get_group("data"))
        return [traj for _, block in sorted(parts, key=lambda p: p[0]) for traj in block]

    def _backend_args(self, kf_rows, results, sc: StagedSuiteChunk):
        """Per sequence with frames in the chunk: (s, backend, process_chunk
        args, kwargs). Each keyframe extraction is queued here, on the
        driver's thread, so the backend threads launch nothing on the card."""
        calls = []
        for s, backend in enumerate(self._mappings):
            n_s = len(sc.stamps[s])
            if n_s == 0:
                continue
            cam = self._camera(s)
            flags = [bool(k) for k in kf_rows[s][:n_s]]
            images = (sc.intensity[s], sc.depth[s])
            kwargs = {"device_images": images}
            kf_js = [j for j, k in enumerate(flags) if k]
            if kf_js:
                kwargs["detect_out"] = backend.dispatch_detect(kf_js, images, cam, self.cfg)
            args = ([(t, None, None) for t in sc.stamps[s]], [r[1] for r in results[s]],
                    [r[2] for r in results[s]], flags, cam, self.cfg)
            calls.append((s, backend, args, kwargs))
        return calls

    def _run_backends(self, states, *work):
        """Synchronous mode: each sequence's chunk to its backend, the
        corrections folded at once (`SequentialOdometry._apply_correction`
        for the suite)."""
        deltas = {}
        for s, backend, a, kw in self._backend_args(*work):
            delta = backend.process_chunk(*a, **kw)
            if delta is not None:
                deltas[s] = np.asarray(delta, np.float64)
        return self._fold(states, deltas)

    def _submit_backends(self, *work):
        return [(s, self._executor.submit(backend.process_chunk, *a, **kw))
                for s, backend, a, kw in self._backend_args(*work)]

    def _drain_backends(self, states):
        """Wait for the previous chunk's backend jobs and fold their
        corrections. Returns (states, per-sequence deltas)."""
        if not self._backend_futures:
            return states, {}
        # detach first: if a job raises, the rest must not fold into a retry
        futures, self._backend_futures = self._backend_futures, None
        deltas = {}
        for s, fut in futures:
            delta = fut.result()
            if delta is not None:
                deltas[s] = np.asarray(delta, np.float64)
        return self._fold(states, deltas), deltas

    def _fold(self, states, deltas):
        if not deltas:
            return states
        S = len(self._mappings)
        dR = np.broadcast_to(np.eye(3, dtype=np.float32), (S, 3, 3)).copy()
        dt = np.zeros((S, 3), np.float32)
        for s, d in deltas.items():
            dR[s] = d[:3, :3]
            dt[s] = d[:3, 3]
        return _fold_corrections(states, torch.as_tensor(dR, device=self.device),
                                 torch.as_tensor(dt, device=self.device))

    @staticmethod
    def _collect(out, stamps, poses: SE3, cov: torch.Tensor, is_kf: Optional[torch.Tensor] = None):
        """The chunk's one fetch, then f64 poses re-orthonormalized by SVD
        on the host, both in the span "suite.collect". With ``is_kf``,
        returns (keyframe flags (S, K), the chunk's results per sequence)."""
        with timer.scope("suite.collect"):
            S, K = poses.t.shape[:2]
            parts = [poses.R.reshape(S, K, 9), poses.t.reshape(S, K, 3), cov.reshape(S, K, 36)]
            if is_kf is not None:
                parts.append(is_kf.reshape(S, K, 1).to(cov.dtype))
            flat = torch.cat(parts, dim=-1).cpu().double().numpy()
            results = [[] for _ in stamps]
            for s, seq_stamps in enumerate(stamps):
                for j, t_ns in enumerate(seq_stamps):
                    T = np.eye(4)
                    u, _, vt = np.linalg.svd(flat[s, j, :9].reshape(3, 3))
                    T[:3, :3] = u @ vt
                    T[:3, 3] = flat[s, j, 9:12]
                    row = (t_ns, T, flat[s, j, 12:48].reshape(6, 6))
                    out[s].append(row)
                    results[s].append(row)
        if is_kf is not None:
            return flat[..., 48] > 0.5, results
