"""Keyframe feature pipeline: detect -> describe -> match -> triangulate.

Port of `vslam_tpu.features.tracking` (reference FeatureTracking,
FeatureTracking.cpp:71-203): on each new keyframe, extract depth-masked FAST
corners (one per grid cell) and steered BRIEF descriptors on the device,
select candidate features from the keyframe window (one per landmark, and
only landmarks that project into the current view), match with the
combined descriptor + reprojection distance (NodeMapping.cpp:103-113),
then extend matched landmarks or triangulate new ones from the current
frame's depth (FeatureTracking.cpp:144-176).

Detection runs where the keyframe's image is. Matching runs on the device
that ``compute_ctx()`` yields (a context-manager factory; the chunk backend
points it at the CPU so matching does not queue behind the scan on the
card). Query and candidate sets are padded to power-of-two sizes, as the
JAX package pads them for its compiled programs.
"""

from __future__ import annotations

import contextlib
import time
from typing import List

import numpy as np
import torch

from ..core import lie_np
from ..core.device import resolve
from ..odometry.map import HostFrame, Landmark, Map
from ..utils import pow2_bucket, timer
from . import descriptor as desc_mod
from . import detector as det_mod
from . import matcher as match_mod

__all__ = ["FeatureTracking"]


def _detect_describe(intensity: torch.Tensor, depth: torch.Tensor, threshold: float = 10.0, cell: int = 30):
    """Keypoints of (..., H, W) images: (uv (..., C, 2), response, valid,
    packed descriptors (..., C, 32) uint8, depth at each keypoint).
    Detection keeps PATCH pixels from the border, so no BRIEF sample
    clamps."""
    det = det_mod.fast_grid_detect(intensity, depth, threshold=threshold, cell=cell, border=desc_mod.PATCH)
    desc = desc_mod.extract_descriptors(intensity, det.uv)
    H, W = depth.shape[-2:]
    u = det.uv[..., 0].to(torch.int64)
    v = det.uv[..., 1].to(torch.int64)
    z = torch.gather(depth.reshape(*depth.shape[:-2], H * W), -1, v * W + u)
    return det.uv, det.response, det.valid, desc_mod.pack_bits(desc), z


def _match_combined(desc_q, uv_q, mask_q, desc_c, p3d_c, mask_c, fx, fy, cx, cy, max_dist):
    """One keyframe's match: packed descriptors (Q, 32) and (M, 32), the
    candidates' points in the query camera (M, 3)."""
    d = match_mod.descriptor_l1_matrix(desc_mod.unpack_bits(desc_q), desc_mod.unpack_bits(desc_c))
    r = match_mod.reprojection_error_matrix(p3d_c, uv_q, fx, fy, cx, cy)
    return match_mod.ratio_match(d + r, max_distance=max_dist, mask_q=mask_q, mask_c=mask_c, unique=True)


def _match_pool_batch(desc_q, uv_q, mask_q, desc_pool, p3d, mask_c, fx, fy, cx, cy, max_dist):
    """A chunk's matches in one call: queries (B, Q, .) against one shared
    candidate pool (P, 32), each query keyframe with its own candidate mask
    (B, P) and the pool's points in its camera (B, P, 3). Returns (idx,
    valid), (B, Q) each."""
    d = match_mod.descriptor_l1_matrix(desc_mod.unpack_bits(desc_q), desc_mod.unpack_bits(desc_pool))
    r = match_mod.reprojection_error_matrix(p3d, uv_q, fx, fy, cx, cy)
    res = match_mod.ratio_match(d + r, max_distance=max_dist, mask_q=mask_q, mask_c=mask_c, unique=True)
    return res.idx, res.valid


def _cam_floats(cam) -> tuple:
    """(fx, fy, cx, cy) as host floats, in one copy where the leaves are tensors."""
    if torch.is_tensor(cam.fx):
        vals = torch.stack([torch.as_tensor(c).reshape(()) for c in (cam.fx, cam.fy, cam.cx, cam.cy)])
        return tuple(float(x) for x in vals.cpu().tolist())
    return tuple(float(c) for c in (cam.fx, cam.fy, cam.cx, cam.cy))


def _bucket(n: int, minimum: int = 64) -> int:
    return pow2_bucket(n, minimum)


class FeatureTracking:
    def __init__(self, fast_threshold: float = 10.0, grid_cell: int = 30, border: float = 5.0,
                 max_match_distance: float = 300.0, device=None):
        """``device``: where matching runs unless ``compute_ctx`` says
        otherwise (CUDA unless named)."""
        self.fast_threshold = fast_threshold
        self.grid_cell = grid_cell
        self.border = border
        self.device = resolve(device)
        # a factory of context managers whose value is the device matching
        # runs on; the chunk backend replaces it (ChunkMappingBackend.compute_device)
        self.compute_ctx = lambda: contextlib.nullcontext(self.device)
        # gate on the combined descriptor + reprojection distance: the
        # reference's 1000 (NodeMapping.cpp:112) is in ORB uchar-L1 units; the
        # steered-BRIEF bit-L1 here is 0..256, so ~80 bits plus a few hundred
        # px of reprojection slack
        self.max_match_distance = float(max_match_distance)

    def extract(self, frame: HostFrame) -> None:
        """Fill frame.keypoints / descriptors / kp_depth / kp_landmark
        (FeatureTracking::extractFeatures) from its level-0 images."""
        with timer.scope("track.extract_dispatch"):
            out = _detect_describe(frame.frame.intensity[0], frame.frame.depth[0],
                                   threshold=self.fast_threshold, cell=self.grid_cell)
        with timer.scope("track.extract_fetch"):
            uv, _resp, keep, desc, z = (t.cpu().numpy() for t in out)
        frame.keypoints = uv[keep]
        frame.descriptors = desc[keep]
        frame.kp_depth = z[keep]
        frame.kp_landmark = np.full(len(frame.keypoints), -1, np.int64)

    def select_candidates(self, cur: HostFrame, refs: List[HostFrame], slam_map: Map, cam_f=None):
        """Candidate features of the reference keyframes: unassociated ones
        always, landmark-associated ones once per landmark and only if the
        landmark projects into the current view (FeatureTracking.cpp:
        178-203). Returns [(ref_frame, feature indices)]."""
        groups = []
        W, H = cur.frame.width(0), cur.frame.height(0)
        fx, fy, cx, cy = cam_f if cam_f is not None else _cam_floats(cur.frame.cameras[0])
        R, t = cur.pose[:3, :3], cur.pose[:3, 3]
        seen = np.empty(0, np.int64)
        for f in refs:
            if f.keypoints is None:
                continue
            pids = np.asarray(f.kp_landmark, np.int64)
            order = np.arange(len(pids))
            un = order[pids < 0]
            assoc = order[pids >= 0]
            accepted = np.empty(0, np.int64)
            if len(assoc):
                # one copy per landmark: its first occurrence in this frame,
                # and none already selected from a more recent reference
                uniq, first = np.unique(pids[assoc], return_index=True)
                fresh = ~np.isin(uniq, seen)
                uniq, first = uniq[fresh], first[fresh]
                pos, ok = slam_map.positions_lookup(uniq)
                p_c = pos @ R.T + t
                z = p_c[:, 2]
                front = ok & (z > 0)
                zs = np.where(front, z, 1.0)
                u = fx * p_c[:, 0] / zs + cx
                v = fy * p_c[:, 1] / zs + cy
                b = self.border
                vis = front & (b < u) & (u < W - b) & (b < v) & (v < H - b)
                accepted = assoc[first[vis]]
                seen = np.concatenate([seen, uniq[vis]])
            idxs = np.sort(np.concatenate([un, accepted]))
            if len(idxs):
                groups.append((f, idxs))
        return groups

    def _candidate_arrays(self, cur, groups, slam_map: Map, cam_f, M: int):
        """Padded candidates: packed descriptors (M, 32), points in the
        current camera (M, 3) (z = -1 where a candidate has no geometry), the
        mask (M,), and the flat (frame, feature index) list."""
        n_cand = sum(len(idxs) for _, idxs in groups)
        desc_c = np.zeros((M, desc_mod.N_BYTES), np.uint8)
        p3d_c = np.zeros((M, 3), np.float32)
        mask_c = np.zeros(M, bool)
        mask_c[:n_cand] = True
        cand: List = []
        R_cur, t_cur = cur.pose[:3, :3], cur.pose[:3, 3]
        fx, fy, cx, cy = cam_f
        j0 = 0
        for f, idxs in groups:
            n = len(idxs)
            desc_c[j0 : j0 + n] = f.descriptors[idxs]
            pids = np.asarray(f.kp_landmark, np.int64)[idxs]
            pos_lm, ok_lm = slam_map.positions_lookup(pids)
            # back-projection by the reference's depth, then to the world
            z = np.asarray(f.kp_depth, np.float64)[idxs]
            uv = np.asarray(f.keypoints, np.float64)[idxs]
            x = (uv[:, 0] - cx) / fx * z
            y = (uv[:, 1] - cy) / fy * z
            Tinv = lie_np.inv(f.pose)
            p_w_depth = np.stack([x, y, z], 1) @ Tinv[:3, :3].T + Tinv[:3, 3]
            p_w = np.where(ok_lm[:, None], pos_lm, p_w_depth)
            usable = ok_lm | (z > 0)
            p_c = p_w @ R_cur.T + t_cur
            p3d_c[j0 : j0 + n] = np.where(usable[:, None], p_c, np.array([0.0, 0.0, -1.0]))
            j0 += n
            cand.extend((f, int(i)) for i in idxs)
        return desc_c, p3d_c, mask_c, cand

    def _query_arrays(self, cur, Q: int):
        """The current keyframe's keypoints padded to Q: packed descriptors,
        uv, mask."""
        nq = len(cur.keypoints)
        desc_q = np.zeros((Q, desc_mod.N_BYTES), np.uint8)
        desc_q[:nq] = cur.descriptors
        uv_q = np.zeros((Q, 2), np.float32)
        uv_q[:nq] = cur.keypoints
        mask_q = np.zeros(Q, bool)
        mask_q[:nq] = True
        return desc_q, uv_q, mask_q

    def _bookkeep(self, cur, idx, ok, cand, cam_f, slam_map: Map) -> List[Landmark]:
        """After a match: extend the matched landmarks, or triangulate new
        ones from the current frame's depth (FeatureTracking.cpp:144-176).
        ``idx`` / ``ok`` hold the real queries only."""
        fx, fy, cx, cy = cam_f
        z_all = np.asarray(cur.kp_depth, np.float64)
        uv_all = np.asarray(cur.keypoints, np.float64)
        Tinv_cur = lie_np.inv(cur.pose)
        xyz = np.stack([(uv_all[:, 0] - cx) / fx * z_all, (uv_all[:, 1] - cy) / fy * z_all, z_all], 1)
        p_w_all = xyz @ Tinv_cur[:3, :3].T + Tinv_cur[:3, 3]

        new_points: List[Landmark] = []
        for qi in np.nonzero(ok)[0]:
            f_ref, ri = cand[int(idx[qi])]
            ref_pid = int(f_ref.kp_landmark[ri])
            if ref_pid >= 0 and slam_map.point(ref_pid) is not None:
                cur.kp_landmark[qi] = ref_pid
                slam_map.point(ref_pid).observations[cur.id] = int(qi)
            elif z_all[qi] > 0:
                lm = Landmark(position=p_w_all[qi], observations={cur.id: int(qi), f_ref.id: ri})
                cur.kp_landmark[qi] = lm.id
                f_ref.kp_landmark[ri] = lm.id
                new_points.append(lm)
        return new_points

    def track(self, cur: HostFrame, slam_map: Map) -> List[Landmark]:
        """One keyframe's tracking; returns the new landmarks. Extraction
        is skipped where the caller filled the feature fields (the chunk
        backend extracts a chunk's keyframes in one batched call)."""
        if cur.keypoints is None:
            with timer.scope("track.extract"):
                self.extract(cur)
        refs = [f for f in slam_map.keyframes() if f is not cur]
        if not refs or cur.keypoints is None or len(cur.keypoints) == 0:
            return []
        cam_f = _cam_floats(cur.frame.cameras[0])
        groups = self.select_candidates(cur, refs, slam_map, cam_f)
        n_cand = sum(len(idxs) for _, idxs in groups)
        if n_cand == 0:
            return []
        desc_c, p3d_c, mask_c, cand = self._candidate_arrays(cur, groups, slam_map, cam_f, _bucket(n_cand))
        nq = len(cur.keypoints)
        desc_q, uv_q, mask_q = self._query_arrays(cur, _bucket(nq))
        with timer.scope("track.match"), self.compute_ctx() as dev:
            t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
            res = _match_combined(t(desc_q), t(uv_q), t(mask_q), t(desc_c), t(p3d_c), t(mask_c), *cam_f,
                                  self.max_match_distance)
            both = torch.stack([res.idx, res.valid.to(res.idx.dtype)]).cpu().numpy()
        idx, ok = both[0], both[1].astype(bool)
        return self._bookkeep(cur, idx[:nq], ok[:nq], cand, cam_f, slam_map)

    def track_batch(self, curs: List[HostFrame], slam_map: Map) -> List[Landmark]:
        """Track a chunk of new keyframes with one match call.

        Every keyframe's candidates come from one shared pool: the world
        geometry of every possible candidate feature does not depend on the
        query (the map does not change before the write-back), so it is
        resolved once per chunk, and each query keeps a boolean mask of its
        own candidates and the pool's points in its camera.

        Semantics against the per-keyframe path: keyframe i's candidates are
        the map at the start of the chunk plus the raw (still unassociated)
        features of the chunk's earlier keyframes; associations made within
        the chunk resolve transitively at the write-back, which reads
        `kp_landmark` when it resolves. The one difference: a window
        landmark re-observed by keyframe i - 1 is a candidate of keyframe i
        both as the landmark and as keyframe i - 1's raw feature.

        Call before inserting ``curs`` into the map: each keyframe's
        references are rebuilt as (the chunk's earlier keyframes, newest
        first) + (the window before the chunk), trimmed to the map's window.
        If the write-back fails part way, the exception carries
        ``mutated_map = True``: the map is then partly written and must not
        be tracked again."""
        all_curs = list(curs)
        # a featureless keyframe keeps its chunk position j: it holds a
        # window slot for the keyframes after it, asks nothing, offers nothing
        queries = [(j, c) for j, c in enumerate(all_curs) if c.keypoints is not None and len(c.keypoints) > 0]
        if not queries:
            return []
        cam_f = _cam_floats(queries[0][1].frame.cameras[0])
        fx, fy, cx, cy = cam_f
        in_chunk = {id(c) for c in all_curs}
        refs_w = [f for f in slam_map.keyframes() if id(f) not in in_chunk]
        window = slam_map.max_keyframes

        # the shared pool, most recent first: the chunk's keyframes (newest
        # first; the last is never a reference), then the window before the
        # chunk, so a segment's rank is its place in any query's references;
        # a featureless reference is an empty segment that still takes a rank
        pool_refs = list(reversed(all_curs[:-1])) + refs_w
        if not pool_refs:
            return []
        t_pool = time.perf_counter()
        seg_rank: List[np.ndarray] = []
        desc_pool_l, pw_l, pid_l, usable_l = [], [], [], []
        cand: List = []
        for r, f in enumerate(pool_refs):
            if f.keypoints is None or len(f.keypoints) == 0:
                continue
            pids = np.asarray(f.kp_landmark, np.int64)
            pos_lm, ok_lm = slam_map.positions_lookup(pids)
            z = np.asarray(f.kp_depth, np.float64)
            uv = np.asarray(f.keypoints, np.float64)
            x = (uv[:, 0] - cx) / fx * z
            y = (uv[:, 1] - cy) / fy * z
            Tinv = lie_np.inv(f.pose)
            p_w_depth = np.stack([x, y, z], 1) @ Tinv[:3, :3].T + Tinv[:3, 3]
            # an associated feature sits at its landmark, the rest at their
            # depth back-projection (z <= 0: no geometry, z = -1 below)
            pw_l.append(np.where(ok_lm[:, None], pos_lm, p_w_depth))
            usable_l.append(ok_lm | (z > 0))
            pid_l.append(np.where(ok_lm, pids, -1))
            desc_pool_l.append(f.descriptors)
            n = len(pids)
            seg_rank.append(np.full(n, r))
            cand.extend((f, int(i)) for i in range(n))
        if not pw_l:
            return []
        pw = np.concatenate(pw_l)
        pids_pool = np.concatenate(pid_l)
        usable = np.concatenate(usable_l)
        rank = np.concatenate(seg_rank)
        n_pool = len(pw)
        P = _bucket(n_pool)
        Q = _bucket(max(len(c.keypoints) for _, c in queries))
        B = _bucket(len(queries), minimum=2)
        desc_pool = np.zeros((P, desc_mod.N_BYTES), np.uint8)
        desc_pool[:n_pool] = np.concatenate(desc_pool_l)

        # every query's candidate points in its camera, one transform
        R_all = np.stack([c.pose[:3, :3] for _, c in queries])
        t_all = np.stack([c.pose[:3, 3] for _, c in queries])
        p_c = np.einsum("mij,pj->mpi", R_all, pw) + t_all[:, None, :]
        p3d = np.full((B, P, 3), -1.0, np.float32)
        p3d[: len(queries), :n_pool] = np.where(usable[None, :, None], p_c, np.array([0.0, 0.0, -1.0]))
        # visibility of the landmark-backed candidates in each query's view
        W_img, H_img = queries[0][1].frame.width(0), queries[0][1].frame.height(0)
        b = self.border
        zq = p_c[:, :, 2]
        zs = np.where(zq > 0, zq, 1.0)
        u = fx * p_c[:, :, 0] / zs + cx
        v = fy * p_c[:, :, 1] / zs + cy
        vis = (zq > 0) & (b < u) & (u < W_img - b) & (b < v) & (v < H_img - b)

        assoc = pids_pool >= 0
        order = np.arange(n_pool)  # rank-major, index-minor already
        mask_c = np.zeros((B, P), bool)
        desc_q = np.zeros((B, Q, desc_mod.N_BYTES), np.uint8)
        uv_q = np.zeros((B, Q, 2), np.float32)
        mask_q = np.zeros((B, Q), bool)
        m_chunk = len(all_curs)
        max_refs = max(window - 1, 1)
        for bi, (j, cur) in enumerate(queries):
            # chunk position j's references are the contiguous ranks from
            # m-1-j on, trimmed to the window (empty segments count)
            lo = m_chunk - 1 - j
            in_refs = (rank >= lo) & (rank < lo + max_refs)
            m_un = in_refs & ~assoc
            sel = in_refs & assoc & usable & vis[bi]
            m_assoc = np.zeros(n_pool, bool)
            if sel.any():
                cand_idx = order[sel]
                _, first = np.unique(pids_pool[cand_idx], return_index=True)
                m_assoc[cand_idx[first]] = True
            mask_c[bi, :n_pool] = m_un | m_assoc
            desc_q[bi], uv_q[bi], mask_q[bi] = self._query_arrays(cur, Q)

        if not mask_c.any():
            return []
        timer.record("track.pool", time.perf_counter() - t_pool)
        with timer.scope("track.match"), self.compute_ctx() as dev:
            t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
            idx, ok = _match_pool_batch(t(desc_q), t(uv_q), t(mask_q), t(desc_pool), t(p3d), t(mask_c),
                                        *cam_f, self.max_match_distance)
            both = torch.stack([idx, ok.to(idx.dtype)]).cpu().numpy()
        idx, ok = both[0], both[1].astype(bool)
        new_points: List[Landmark] = []
        t_book = time.perf_counter()
        try:
            for bi, (_j, cur) in enumerate(queries):
                nq = len(cur.keypoints)
                pts = self._bookkeep(cur, idx[bi][:nq], ok[bi][:nq], cand, cam_f, slam_map)
                # landmarks of this chunk resolve for its later keyframes
                slam_map.insert_points(pts)
                new_points.extend(pts)
        except Exception as exc:
            exc.mutated_map = True
            raise
        timer.record("track.bookkeep", time.perf_counter() - t_book)
        return new_points
