"""TUM RGB-D benchmark metrics: timestamp association, ATE, RPE.

A copy of `vslam_tpu.eval.metrics` (numpy only): the port must run where
JAX is not installed.

Fresh implementations with the same protocol as the reference's vendored TUM
scripts (`script/vslam_evaluation/tum/{associate,evaluate_ate,evaluate_rpe}.py`):
- associate: greedy closest-timestamp matching within max_difference
  (associate.py:49-128)
- ATE: Horn/SVD rigid alignment of matched translations, RMSE of residuals
  (evaluate_ate.py:47-79)
- RPE: relative-pose error over fixed-delta pairs; the reference driver runs
  it with --fixed_delta --delta_unit s (script/evaluate.py:65-75)
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core import lie_np

__all__ = [
    "associate",
    "align_horn",
    "ate_rmse",
    "rpe",
    "evaluate_rpe_full",
    "rpe_stats",
    "summarize",
]


def associate(
    ts_a: Sequence[float],
    ts_b: Sequence[float],
    offset: float = 0.0,
    max_difference: float = 0.02,
) -> List[Tuple[int, int]]:
    """Greedy best-first matching of two timestamp lists. Returns index pairs
    (ia, ib), each timestamp used at most once.

    Candidate generation is vectorized with searchsorted (the naive
    all-pairs double loop is O(N*M) interpreted Python — tens of millions of
    iterations on fr2_desk-sized trajectories); only the (a, b) pairs within
    max_difference are enumerated, which preserves the reference protocol
    (associate.py:49-128) exactly.
    """
    a = np.asarray(ts_a, np.float64)
    b = np.asarray(ts_b, np.float64) + offset
    if a.size == 0 or b.size == 0:
        return []
    order_b = np.argsort(b, kind="stable")
    b_sorted = b[order_b]
    lo = np.searchsorted(b_sorted, a - max_difference, side="left")
    hi = np.searchsorted(b_sorted, a + max_difference, side="right")
    counts = hi - lo
    ia_all = np.repeat(np.arange(a.size), counts)
    # per-a candidate offsets into b_sorted
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ib_sorted = lo[ia_all] + (np.arange(ia_all.size) - starts[ia_all])
    ib_all = order_b[ib_sorted]
    d_all = np.abs(a[ia_all] - b[ib_all])
    keep = d_all < max_difference  # strict, matching the reference
    ia_all, ib_all, d_all = ia_all[keep], ib_all[keep], d_all[keep]

    order = np.lexsort((ib_all, ia_all, d_all))
    used_a = np.zeros(a.size, bool)
    used_b = np.zeros(b.size, bool)
    matches = []
    for k in order:  # O(#candidates) with small windows, not O(N*M)
        ia, ib = int(ia_all[k]), int(ib_all[k])
        if not used_a[ia] and not used_b[ib]:
            used_a[ia] = True
            used_b[ib] = True
            matches.append((ia, ib))
    matches.sort()
    return matches


def align_horn(model: np.ndarray, data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Least-squares rigid transform (R, t) minimizing ||R model + t - data||
    via SVD (Horn's method). model/data: (N, 3)."""
    mu_m = model.mean(axis=0)
    mu_d = data.mean(axis=0)
    Mc = model - mu_m
    Dc = data - mu_d
    W = Mc.T @ Dc
    U, _, Vt = np.linalg.svd(W)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = Vt.T @ S @ U.T
    t = mu_d - R @ mu_m
    return R, t


def ate_rmse(
    gt: Dict[float, np.ndarray],
    est: Dict[float, np.ndarray],
    max_difference: float = 0.02,
) -> Tuple[float, int]:
    """Absolute trajectory error. Poses are cam->world 4x4 (TUM convention:
    the file rows are the camera pose in the world). Returns (rmse, n)."""
    ts_g = sorted(gt.keys())
    ts_e = sorted(est.keys())
    matches = associate(ts_g, ts_e, max_difference=max_difference)
    if len(matches) < 2:
        raise ValueError(f"Couldn't associate trajectories ({len(matches)} matches)")
    P_g = np.stack([gt[ts_g[ia]][:3, 3] for ia, _ in matches])
    P_e = np.stack([est[ts_e[ib]][:3, 3] for _, ib in matches])
    R, t = align_horn(P_e, P_g)
    aligned = P_e @ R.T + t
    err = aligned - P_g
    return float(np.sqrt(np.mean(np.sum(err * err, axis=1)))), len(matches)


def evaluate_ate_full(
    gt: Dict[float, np.ndarray],
    est: Dict[float, np.ndarray],
    offset: float = 0.0,
    scale: float = 1.0,
    max_difference: float = 0.02,
) -> Tuple[Dict[str, float], np.ndarray, np.ndarray]:
    """The complete ATE protocol of the reference's TUM script
    (`script/vslam_evaluation/tum/evaluate_ate.py:118-162` in the reference),
    option-for-option: associate with a time offset on the estimated stamps,
    scale the estimated xyz, Horn-align estimate onto ground truth over the
    MATCHED pairs, per-pair translational errors.

    Returns (stats, assoc_rows, aligned_full):
    - stats: the --verbose keys (compared_pose_pairs +
      absolute_translational_error.{rmse,mean,median,std,min,max});
    - assoc_rows (N, 8): [stamp_gt, gt xyz, stamp_est, aligned est xyz] —
      the --save_associations format;
    - aligned_full (M, 4): [stamp_est, aligned est xyz] over ALL estimated
      stamps (not just matches) — the --save format.
    """
    ts_g = sorted(gt.keys())
    ts_e = sorted(est.keys())
    matches = associate(ts_g, ts_e, offset=offset, max_difference=max_difference)
    if len(matches) < 2:
        raise ValueError(
            "Couldn't find matching timestamp pairs between groundtruth and "
            "estimated trajectory!"
        )
    P_g = np.stack([gt[ts_g[ia]][:3, 3] for ia, _ in matches])
    P_e = np.stack([est[ts_e[ib]][:3, 3] for _, ib in matches]) * scale
    R, t = align_horn(P_e, P_g)
    aligned = P_e @ R.T + t
    err = np.linalg.norm(aligned - P_g, axis=1)
    stats = {
        "compared_pose_pairs": int(len(matches)),
        "absolute_translational_error.rmse": float(np.sqrt(np.mean(err**2))),
        "absolute_translational_error.mean": float(np.mean(err)),
        "absolute_translational_error.median": float(np.median(err)),
        "absolute_translational_error.std": float(np.std(err)),
        "absolute_translational_error.min": float(np.min(err)),
        "absolute_translational_error.max": float(np.max(err)),
    }
    assoc_rows = np.concatenate(
        [
            np.asarray([ts_g[ia] for ia, _ in matches])[:, None],
            P_g,
            np.asarray([ts_e[ib] for _, ib in matches])[:, None],
            aligned,
        ],
        axis=1,
    )
    full = np.stack([est[s][:3, 3] for s in ts_e]) * scale
    aligned_full = np.concatenate(
        [np.asarray(ts_e)[:, None], full @ R.T + t], axis=1
    )
    return stats, assoc_rows, aligned_full


def rpe(
    gt: Dict[float, np.ndarray],
    est: Dict[float, np.ndarray],
    fixed_delta: float = 1.0,
    max_difference: float = 0.02,
) -> Tuple[float, float, int]:
    """Relative pose error over pairs (t, t+delta) of the estimated
    trajectory, compared against ground truth over the same interval.
    Returns (trans_rmse [m], rot_rmse [rad], n_pairs)."""
    ts_g = sorted(gt.keys())
    ts_e = sorted(est.keys())
    matches = associate(ts_g, ts_e, max_difference=max_difference)
    if len(matches) < 2:
        raise ValueError("Couldn't associate trajectories")
    pairs_g = [ts_g[ia] for ia, _ in matches]
    pairs_e = [ts_e[ib] for _, ib in matches]

    t_errs, r_errs = [], []
    te = np.asarray(pairs_e)
    for i in range(len(matches)):
        target = pairs_e[i] + fixed_delta
        j = int(np.searchsorted(te, target))
        if j >= len(matches):
            continue
        # accept the closest index to the requested delta within 20% slack
        if j > 0 and abs(te[j - 1] - target) < abs(te[j] - target):
            j = j - 1
        if abs(te[j] - target) > 0.2 * fixed_delta:
            continue
        # TUM convention: poses are cam->world; relative motion over the
        # interval is inv(p_i) . p_j (evaluate_rpe.py ominus)
        rel_e = lie_np.inv(est[pairs_e[i]]) @ est[pairs_e[j]]
        rel_g = lie_np.inv(gt[pairs_g[i]]) @ gt[pairs_g[j]]
        E = lie_np.inv(rel_g) @ rel_e
        t_errs.append(np.linalg.norm(E[:3, 3]))
        r_errs.append(np.linalg.norm(lie_np.matrix_to_rotvec(E[:3, :3])))
    if not t_errs:
        raise ValueError("No RPE pairs found")
    t_errs = np.asarray(t_errs)
    r_errs = np.asarray(r_errs)
    return (
        float(np.sqrt(np.mean(t_errs**2))),
        float(np.sqrt(np.mean(r_errs**2))),
        len(t_errs),
    )


def _find_closest_index(L: np.ndarray, t: float) -> int:
    """Index of the closest value in a sorted array (evaluate_rpe.py's
    binary-search helper, vectorized)."""
    j = int(np.searchsorted(L, t))
    if j >= len(L):
        return len(L) - 1
    if j > 0 and abs(L[j - 1] - t) <= abs(L[j] - t):
        return j - 1
    return j


def _motion_angle(T: np.ndarray) -> float:
    return float(np.arccos(min(1.0, max(-1.0, (np.trace(T[:3, :3]) - 1.0) / 2.0))))


def _distances_along(traj: Dict[float, np.ndarray], stamps: List[float], angular: bool) -> np.ndarray:
    """Cumulative translational distance (m) or rotation angle (rad) along the
    trajectory — the delta index for delta_unit 'm' / 'rad' / 'deg'."""
    out = [0.0]
    acc = 0.0
    for a, b in zip(stamps[:-1], stamps[1:]):
        # NOTE the reference's operand order: ominus(traj[k+1], traj[k])
        rel = lie_np.inv(traj[b]) @ traj[a]
        acc += _motion_angle(rel) if angular else float(np.linalg.norm(rel[:3, 3]))
        out.append(acc)
    return np.asarray(out)


def evaluate_rpe_full(
    traj_gt: Dict[float, np.ndarray],
    traj_est: Dict[float, np.ndarray],
    max_pairs: int = 10000,
    fixed_delta: bool = False,
    delta: float = 1.0,
    delta_unit: str = "s",
    offset: float = 0.0,
    scale: float = 1.0,
    seed: int = 0,
) -> np.ndarray:
    """The complete RPE protocol of the reference's TUM script
    (`script/vslam_evaluation/tum/evaluate_rpe.py:204-297`,
    `evaluate_trajectory`), option-for-option:

    - delta_unit 's' (timestamps), 'm' (meters along trajectory), 'rad'/'deg'
      (rotation along trajectory), 'f' (frames);
    - fixed_delta picks, per index i, the closest index j at delta distance
      (pairs whose j is the LAST index are dropped — a reference protocol
      quirk kept for parity); otherwise all pairs, downsampled to max_pairs
      with the seeded stdlib RNG (the script calls random.seed(0));
    - offset shifts the estimated timestamps against ground truth; gt stamps
      further than 2x the median gt interval from a requested stamp drop the
      pair;
    - scale multiplies the estimated relative translation;
    - the pair error is ominus(scale(ominus(est_j, est_i)), ominus(gt_j, gt_i))
      with ominus(a, b) = inv(a) @ b (note the j-before-i operand order).

    Returns an (N, 6) array of rows
    [stamp_est_0, stamp_est_1, stamp_gt_0, stamp_gt_1, trans_err, rot_err]
    — the reference's --save file format.
    """
    import random as _random

    stamps_gt = np.asarray(sorted(traj_gt.keys()), np.float64)
    stamps_est_list = sorted(traj_est.keys())
    stamps_est = np.asarray(stamps_est_list, np.float64)
    n = len(stamps_est)

    if delta_unit == "s":
        index_est = stamps_est
    elif delta_unit == "m":
        index_est = _distances_along(traj_est, stamps_est_list, angular=False)
    elif delta_unit == "rad":
        index_est = _distances_along(traj_est, stamps_est_list, angular=True)
    elif delta_unit == "deg":
        index_est = _distances_along(traj_est, stamps_est_list, angular=True) * (
            180.0 / np.pi
        )
    elif delta_unit == "f":
        index_est = np.arange(n, dtype=np.float64)
    else:
        raise ValueError(f"Unknown unit for delta: '{delta_unit}'")

    rng = _random.Random(seed)
    if not fixed_delta:
        if max_pairs == 0 or n < np.sqrt(max_pairs):
            pairs = [(i, j) for i in range(n) for j in range(n)]
        else:
            pairs = [
                (rng.randint(0, n - 1), rng.randint(0, n - 1))
                for _ in range(max_pairs)
            ]
    else:
        pairs = []
        for i in range(n):
            j = _find_closest_index(index_est, index_est[i] + delta)
            if j != n - 1:
                pairs.append((i, j))
        if max_pairs != 0 and len(pairs) > max_pairs:
            pairs = rng.sample(pairs, max_pairs)

    gt_interval = float(np.median(np.diff(stamps_gt))) if len(stamps_gt) > 1 else 0.0
    gt_max_dt = 2.0 * gt_interval

    rows = []
    for i, j in pairs:
        s_e0, s_e1 = float(stamps_est[i]), float(stamps_est[j])
        g0 = float(stamps_gt[_find_closest_index(stamps_gt, s_e0 + offset)])
        g1 = float(stamps_gt[_find_closest_index(stamps_gt, s_e1 + offset)])
        if abs(g0 - (s_e0 + offset)) > gt_max_dt or abs(g1 - (s_e1 + offset)) > gt_max_dt:
            continue
        rel_est = lie_np.inv(traj_est[s_e1]) @ traj_est[s_e0]
        rel_est = rel_est.copy()
        rel_est[:3, 3] *= scale
        rel_gt = lie_np.inv(traj_gt[g1]) @ traj_gt[g0]
        E = lie_np.inv(rel_est) @ rel_gt
        rows.append([s_e0, s_e1, g0, g1, float(np.linalg.norm(E[:3, 3])), _motion_angle(E)])
    if len(rows) < 2:
        raise ValueError(
            "Couldn't find matching timestamp pairs between groundtruth and "
            "estimated trajectory!"
        )
    return np.asarray(rows, np.float64)


def rpe_stats(rows: np.ndarray) -> Dict[str, float]:
    """Summary statistics in the reference script's --verbose format
    (translational in m, rotational in deg)."""
    trans = rows[:, 4]
    rot = rows[:, 5]
    deg = 180.0 / np.pi
    return {
        "compared_pose_pairs": int(len(rows)),
        "translational_error.rmse": float(np.sqrt(np.mean(trans**2))),
        "translational_error.mean": float(np.mean(trans)),
        "translational_error.median": float(np.median(trans)),
        "translational_error.std": float(np.std(trans)),
        "translational_error.min": float(np.min(trans)),
        "translational_error.max": float(np.max(trans)),
        "rotational_error.rmse": float(np.sqrt(np.mean(rot**2)) * deg),
        "rotational_error.mean": float(np.mean(rot) * deg),
        "rotational_error.median": float(np.median(rot) * deg),
        "rotational_error.std": float(np.std(rot) * deg),
        "rotational_error.min": float(np.min(rot) * deg),
        "rotational_error.max": float(np.max(rot) * deg),
    }


def summarize(
    gt: Dict[float, np.ndarray], est: Dict[float, np.ndarray]
) -> Dict[str, float]:
    ate, n_ate = ate_rmse(gt, est)
    # default 1 s RPE interval (the TUM protocol's common choice), capped to
    # a third of the overlap span so short clips still report a number
    span = max(est.keys()) - min(est.keys())
    rpe_t, rpe_r, n_rpe = rpe(gt, est, fixed_delta=min(1.0, max(span / 3, 1e-3)))
    return {
        "ate_rmse_m": ate,
        "rpe_trans_rmse_m": rpe_t,
        "rpe_rot_rmse_rad": rpe_r,
        "n_ate_pairs": n_ate,
        "n_rpe_pairs": n_rpe,
    }
