"""Global keyframe pose-graph backend: odometry edges and loop closures.

Port of `vslam_tpu.odometry.graph_backend`: every keyframe becomes a node
with an odometry edge to the previous keyframe; when the `KeyframeDatabase`
verifies a loop closure, the whole graph is optimized
(`ba.pose_graph.optimize_pose_graph` on ``device``, padded to power-of-two
sizes) and the corrected keyframe poses are handed back for write-back. The
drift-collapse mechanism the reference lacks (its backend stops at
windowed BA).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ba.pose_graph import PoseGraph, optimize_pose_graph, pad_pose_graph
from ..core import lie_np
from ..core.device import resolve
from ..core.se3 import SE3
from ..features.loop_closure import KeyframeDatabase, LoopClosureConfig
from ..utils import pow2_bucket
from ..utils.log import get_logger

__all__ = ["PoseGraphBackend"]


class PoseGraphBackend:
    def __init__(self, cfg: LoopClosureConfig = LoopClosureConfig(), odo_info_scale: float = 1e2,
                 fold_min_span_frac: float = 0.5, device=None):
        """``device``: where place recognition's matching and the graph
        solve run (CUDA unless named)."""
        # online-fold policy: every closure updates the graph (it sharpens
        # the post-run anchoring), but only a closure spanning at least this
        # share of the keyframe history folds into the live pose chain
        self.fold_min_span_frac = float(fold_min_span_frac)
        self.device = resolve(device)
        self.db = KeyframeDatabase(cfg, device=self.device)
        self.kf_ids: List[int] = []
        self.kf_poses: Dict[int, np.ndarray] = {}  # id -> world->cam 4x4
        self.kf_stamps: Dict[int, int] = {}  # id -> t_ns
        self.edges: List[Tuple[int, int, np.ndarray, np.ndarray]] = []  # (i, j, rel, info)
        self.n_closures = 0
        self._odo_info = np.eye(6) * odo_info_scale
        self._log = get_logger("mapping")
        # wall seconds of the last and the slowest graph solve, and the last
        # solve's node count
        self.last_solve_s = 0.0
        self.max_solve_s = 0.0
        self.last_solve_nodes = 0
        # whether the last closure's correction of the current keyframe
        # exceeds the closure's own measured noise and spans enough history
        # (try_close); consumers fold it into the live chain only then
        self.last_closure_significant = True

    def add_keyframe(self, frame) -> None:
        """Register a keyframe (a HostFrame with features) and the odometry
        edge from the previous keyframe."""
        if self.kf_ids:
            prev = self.kf_ids[-1]
            rel = frame.pose @ lie_np.inv(self.kf_poses[prev])  # T_j . T_i^-1
            self.edges.append((prev, frame.id, rel, self._odo_info.copy()))
        self.kf_ids.append(frame.id)
        self.kf_poses[frame.id] = np.asarray(frame.pose, np.float64).copy()
        self.kf_stamps[frame.id] = int(frame.t_ns)
        self.db.add(frame)

    def keyframe_trajectory(self) -> List[Tuple[int, np.ndarray]]:
        """(t_ns, world->cam 4x4) of every keyframe, sorted by time: the
        graph's current belief, the anchors of `sequential_mapping.
        anchor_trajectory`."""
        return sorted(((self.kf_stamps[fid], self.kf_poses[fid]) for fid in self.kf_ids), key=lambda x: x[0])

    def try_close(self, frame) -> Optional[Dict[int, np.ndarray]]:
        """Attempt a loop closure at this keyframe. On success, optimize the
        graph and return {kf_id: corrected pose} (also kept here)."""
        cand = self.db.query(frame)
        if cand is None:
            return None
        self._log.info("loop closure: kf %d -> kf %d (%d inliers)", frame.id, cand.kf_id, cand.n_inliers)
        self.edges.append((cand.kf_id, frame.id, cand.rel, cand.info))
        self.n_closures += 1
        pose_before = self.kf_poses[frame.id].copy()
        out = self._optimize()
        # fold online only a correction above 3 sigma_t of the closure's
        # Horn fit (and the BA gate's 1 mm floor) from a closure spanning
        # enough of the history; the graph keeps every correction
        d = lie_np.log(lie_np.inv(pose_before) @ out[frame.id])
        thresh = max(3.0 * float(getattr(cand, "sigma_t", 0.0)), 1e-3)
        try:
            span = len(self.kf_ids) - 1 - self.kf_ids.index(cand.kf_id)
        except ValueError:
            span = 0
        span_frac = span / max(len(self.kf_ids) - 1, 1)
        self.last_closure_significant = bool(np.linalg.norm(d[:3]) > thresh
                                             and span_frac >= self.fold_min_span_frac)
        if not self.last_closure_significant:
            self._log.info("closure correction %.4f m (3*sigma_t %.4f, span %.2f of history) — not folded "
                           "online", float(np.linalg.norm(d[:3])), thresh, span_frac)
        return out

    def _optimize(self) -> Dict[int, np.ndarray]:
        ids = self.kf_ids
        index = {fid: k for k, fid in enumerate(ids)}
        K = len(ids)
        E = len(self.edges)
        dev = self.device
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)  # noqa: E731
        i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)  # noqa: E731
        poses = np.stack([self.kf_poses[f] for f in ids])
        rels = np.stack([e[2] for e in self.edges])
        g = PoseGraph(
            poses=SE3(f32(poses[:, :3, :3]), f32(poses[:, :3, 3])),
            edge_i=i64([index[e[0]] for e in self.edges]),
            edge_j=i64([index[e[1]] for e in self.edges]),
            edge_rel=SE3(f32(rels[:, :3, :3]), f32(rels[:, :3, 3])),
            edge_info=f32(np.stack([e[3] for e in self.edges])),
            edge_mask=torch.ones(E, dtype=torch.bool, device=dev),
        )
        g, node_mask = pad_pose_graph(g, pow2_bucket(K), pow2_bucket(E))
        t_solve = time.perf_counter()
        # solver "auto": PCG above pose_graph._DENSE_MAX_NODES padded nodes, dense below
        opt, c0, c1 = optimize_pose_graph(g, node_mask=node_mask)
        flat = torch.cat([opt.R[:K].reshape(-1), opt.t[:K].reshape(-1), c0.reshape(1), c1.reshape(1)])
        flat = flat.cpu().numpy().astype(np.float64)
        self.last_solve_s = time.perf_counter() - t_solve
        self.max_solve_s = max(self.max_solve_s, self.last_solve_s)
        self.last_solve_nodes = K
        R = flat[: 9 * K].reshape(K, 3, 3)
        t = flat[9 * K : 12 * K].reshape(K, 3)
        out: Dict[int, np.ndarray] = {}
        for k, fid in enumerate(ids):
            T = np.eye(4)
            u, _, vt = np.linalg.svd(R[k])
            T[:3, :3] = u @ vt
            T[:3, 3] = t[k]
            self.kf_poses[fid] = T
            out[fid] = T
        self._log.info("pose graph: chi2 %.4g -> %.4g (%d nodes, %d edges)", flat[-2], flat[-1], K, E)
        return out

    def update_pose(self, fid: int, pose: np.ndarray) -> None:
        """Keep the graph consistent with external write-backs (BA)."""
        if fid in self.kf_poses:
            self.kf_poses[fid] = np.asarray(pose, np.float64).copy()
