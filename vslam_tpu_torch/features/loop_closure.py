"""Loop closure: keyframe place recognition and geometric verification.

Port of `vslam_tpu.features.loop_closure` (a capability beyond the
reference, whose backend stops at windowed BA; SURVEY §7 M5), feeding the
pose graph (`ba/pose_graph.py`):

- place recognition: every keyframe's BRIEF-256 set is kept in a host-side
  database; a query shortlists past keyframes by a mean-pooled global
  descriptor, then scores each by ratio-test matches, one (N, M) descriptor
  distance matrix per comparison (`matcher.descriptor_l1_matrix`) on the
  database's ``device``;
- geometric verification: matches with valid depth give 3D-3D
  correspondences, and a Kabsch/Horn RANSAC (numpy, seeded by the matched
  keyframe's id) estimates the relative transform and counts inliers.

An accepted closure is a pose-graph edge (i_old, j_new, rel = T_new .
T_old^-1, information).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..core.device import resolve
from ..eval.metrics import align_horn
from . import descriptor as desc_mod
from . import matcher as match_mod

__all__ = ["LoopClosureConfig", "LoopCandidate", "KeyframeDatabase", "estimate_rel_3d3d"]


@dataclasses.dataclass(frozen=True)
class LoopClosureConfig:
    min_gap: int = 5  # skip this many most recent keyframes (temporal neighbours)
    min_matches: int = 12  # descriptor matches to attempt verification
    min_inliers: int = 10  # 3D-3D RANSAC inliers to accept the loop
    ransac_iterations: int = 100
    inlier_threshold: float = 0.05  # [m]
    max_descriptor_distance: float = 80.0  # L1 bits (of 256)
    # the full match and verification run only for this many entries closest
    # in the global-descriptor space; 0 scores every entry
    max_candidates: int = 5


class LoopCandidate(NamedTuple):
    kf_id: int  # matched (older) keyframe id
    rel: np.ndarray  # 4x4, T_new . T_old^-1 (world->cam convention)
    n_inliers: int
    info: np.ndarray  # (6, 6) edge information
    # measured standard error of the fitted translation: rms inlier 3-D
    # residual / sqrt(n_inliers); the online-fold gate compares the claimed
    # drift with it (graph_backend.try_close)
    sigma_t: float = 0.0


def estimate_rel_3d3d(p_old: np.ndarray, p_new: np.ndarray, iterations: int = 100, threshold: float = 0.05,
                      seed: int = 0):
    """RANSAC Kabsch: rigid T with p_new ~= R p_old + t, from (N, 3) point
    pairs. Returns (T 4x4, inlier mask). All hypotheses at once: one batched
    SVD over a (K, 3, 3) stack and one (K, N) residual matrix."""
    N = len(p_old)
    rng = np.random.default_rng(seed)
    best_inl = np.zeros(N, bool)
    if N < 3:
        return np.eye(4), best_inl
    idx = np.stack([rng.choice(N, 3, replace=False) for _ in range(iterations)])
    po = p_old[idx]
    pn = p_new[idx]
    mu_o = po.mean(axis=1, keepdims=True)
    mu_n = pn.mean(axis=1, keepdims=True)
    W = np.einsum("kij,kil->kjl", po - mu_o, pn - mu_n)
    # a non-finite or degenerate triple must not abort the whole stack: its
    # W is replaced by the identity and its inliers zeroed, and if the
    # batched SVD still fails, hypotheses are decomposed one by one
    bad = ~np.isfinite(W).all(axis=(1, 2))
    if bad.any():
        W = np.where(bad[:, None, None], np.eye(3), W)
    try:
        U, _, Vt = np.linalg.svd(W)
    except np.linalg.LinAlgError:
        U = np.repeat(np.eye(3)[None], iterations, axis=0)
        Vt = np.repeat(np.eye(3)[None], iterations, axis=0)
        for k in range(iterations):
            try:
                U[k], _, Vt[k] = np.linalg.svd(W[k])
            except np.linalg.LinAlgError:
                bad[k] = True
    det = np.linalg.det(np.einsum("kij,kjl->kil", U, Vt))
    S = np.repeat(np.eye(3)[None], iterations, axis=0)
    S[:, 2, 2] = np.sign(det) + (det == 0)
    R_all = np.einsum("kji,kjl,kml->kim", Vt, S, U)  # V S U^T per hypothesis
    t_all = mu_n[:, 0, :] - np.einsum("kij,kj->ki", R_all, mu_o[:, 0, :])
    pred = np.einsum("kij,nj->kni", R_all, p_old) + t_all[:, None, :]
    err = np.linalg.norm(pred - p_new[None], axis=2)
    inl_all = err < threshold
    inl_all[bad] = False
    best_inl = inl_all[np.argmax(inl_all.sum(axis=1))]
    R, t = np.eye(3), np.zeros(3)  # no consensus (the caller checks the inliers)
    if best_inl.sum() >= 3:
        R, t = align_horn(p_old[best_inl], p_new[best_inl])
        refined = np.linalg.norm(p_old @ R.T + t - p_new, axis=1) < threshold
        if refined.sum() >= 3:
            R, t = align_horn(p_old[refined], p_new[refined])
        # the mask of the returned transform (it gates acceptance and scales
        # the edge information)
        best_inl = np.linalg.norm(p_old @ R.T + t - p_new, axis=1) < threshold
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T, best_inl


@dataclasses.dataclass
class _Entry:
    kf_id: int
    descriptors: np.ndarray  # (N, 32) packed uint8
    p_cam: np.ndarray  # (N, 3) camera-frame points (z = -1 where no depth)
    gdesc: np.ndarray  # (256,) global descriptor: the mean BRIEF bit vector


def _as_packed(desc: np.ndarray) -> np.ndarray:
    """(N, 32) packed uint8 descriptors from either representation."""
    desc = np.asarray(desc)
    if desc.dtype == np.uint8 and desc.shape[-1] == desc_mod.N_BYTES:
        return desc
    return np.packbits(desc.astype(np.float32) > 0.5, axis=-1)


def _global_descriptor(descriptors: np.ndarray) -> np.ndarray:
    """Mean-pooled BRIEF bit vector: each of the 256 tests becomes the
    share of keypoints for which it fired (a bag-of-bits image signature)."""
    return np.asarray(descriptors, np.float32).mean(axis=0)


class KeyframeDatabase:
    """Host-side place-recognition database over keyframe descriptor sets;
    descriptor matching runs on ``device`` (CUDA unless named)."""

    def __init__(self, cfg: LoopClosureConfig = LoopClosureConfig(), device=None):
        self.cfg = cfg
        self.device = resolve(device)
        self._entries: List[_Entry] = []

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _points_cam(frame) -> np.ndarray:
        """(N, 3) camera-frame points from keypoints and depth (z = -1 where invalid)."""
        from .tracking import _cam_floats

        fx, fy, cx, cy = _cam_floats(frame.frame.cameras[0])
        uv = np.asarray(frame.keypoints, np.float64)
        z = np.asarray(frame.kp_depth, np.float64)
        ok = z > 0
        zs = np.where(ok, z, 1.0)
        x = (uv[:, 0] - cx) / fx * zs
        y = (uv[:, 1] - cy) / fy * zs
        p = np.stack([x, y, zs], axis=1)
        p[~ok] = [0.0, 0.0, -1.0]
        return p

    def add(self, frame) -> None:
        """Register a keyframe (a HostFrame with extracted features)."""
        if frame.keypoints is None or len(frame.keypoints) == 0:
            return
        self._entries.append(_Entry(kf_id=frame.id, descriptors=_as_packed(frame.descriptors),
                                    p_cam=self._points_cam(frame),
                                    gdesc=_global_descriptor(desc_mod.as_float_bits(frame.descriptors))))

    def query(self, frame) -> Optional[LoopCandidate]:
        """A verified loop closure for the keyframe (already added, or about
        to be), or None."""
        cfg = self.cfg
        if frame.keypoints is None or len(frame.keypoints) == 0:
            return None
        own = next((e for e in self._entries if e.kf_id == frame.id), None)
        candidates = [e for e in self._entries if e.kf_id != frame.id]
        candidates = candidates[: len(candidates) - cfg.min_gap] if len(candidates) > cfg.min_gap else []
        if not candidates:
            return None
        if cfg.max_candidates > 0 and len(candidates) > cfg.max_candidates:
            # shortlist by the global descriptor: one (C, 256) L1 scan, so a
            # query's verification work stays flat in the database's size
            gq = own.gdesc if own is not None else _global_descriptor(desc_mod.as_float_bits(frame.descriptors))
            G = np.stack([e.gdesc for e in candidates])
            score = np.abs(G - gq[None]).sum(axis=1)
            keep = np.argsort(score)[: cfg.max_candidates]
            candidates = [candidates[i] for i in keep]
        packed_q = own.descriptors if own is not None else _as_packed(frame.descriptors)
        desc_q = desc_mod.unpack_bits(torch.as_tensor(packed_q, device=self.device))
        p_new_all = own.p_cam if own is not None else self._points_cam(frame)

        best: Optional[LoopCandidate] = None
        for e in candidates:
            d = match_mod.descriptor_l1_matrix(
                desc_q, desc_mod.unpack_bits(torch.as_tensor(_as_packed(e.descriptors), device=self.device)))
            res = match_mod.ratio_match(d, max_distance=cfg.max_descriptor_distance, unique=True)
            both = torch.stack([res.valid.to(res.idx.dtype), res.idx]).cpu().numpy()
            ok, idx = both[0].astype(bool), both[1]
            if int(ok.sum()) < cfg.min_matches:
                continue
            qi = np.nonzero(ok)[0]
            ci = idx[qi]
            p_new = p_new_all[qi]
            p_old = e.p_cam[ci]
            geom = (p_new[:, 2] > 0) & (p_old[:, 2] > 0)
            if geom.sum() < 3:
                continue
            T, inl = estimate_rel_3d3d(p_old[geom], p_new[geom], iterations=cfg.ransac_iterations,
                                       threshold=cfg.inlier_threshold, seed=e.kf_id)
            n_inl = int(inl.sum())
            if n_inl >= cfg.min_inliers and (best is None or n_inl > best.n_inliers):
                # information grows with the inlier support; the rotation
                # block stiffer than the translation's
                info = np.eye(6) * (n_inl * 10.0)
                info[3:, 3:] *= 4.0
                po, pn = p_old[geom][inl], p_new[geom][inl]
                r3 = pn - (po @ T[:3, :3].T + T[:3, 3])
                sigma_t = float(np.sqrt(np.mean(np.sum(r3 * r3, axis=1)) / max(n_inl, 1)))
                best = LoopCandidate(kf_id=e.kf_id, rel=T, n_inliers=n_inl, info=info, sigma_t=sigma_t)
        return best
