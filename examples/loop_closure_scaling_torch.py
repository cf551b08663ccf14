"""Loop-closure backend latency vs. database size, on the port
(`vslam_tpu_torch`; the same timing as `examples/loop_closure_scaling.py`).

Times `KeyframeDatabase.query` at growing database sizes with and without the
global-descriptor shortlist (`LoopClosureConfig.max_candidates`). With the
shortlist the per-query cost is one O(C*256) host scan plus a FIXED number of
descriptor-matrix + RANSAC verifications, so latency stays flat as the
database grows; the unfiltered scan makes one (N, M) descriptor matrix per
keyframe on the device. Each row also gives each mode's answer: "none", or
the matched keyframe and its inlier count as "kf<id>/<inliers>".

Usage: python examples/loop_closure_scaling_torch.py [sizes...] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vslam_tpu_torch.core.device import resolve
from vslam_tpu_torch.features import loop_closure as lc


def build_db(n: int, cfg: lc.LoopClosureConfig, rng, device) -> lc.KeyframeDatabase:
    db = lc.KeyframeDatabase(cfg, device=device)
    for k in range(n):
        desc = (rng.random((200, 256)) < rng.uniform(0.3, 0.7, 256)).astype(np.float32)
        pts = rng.uniform(-1, 1, (200, 3)) + [0, 0, 2.0]
        db._entries.append(
            lc._Entry(kf_id=k, descriptors=desc, p_cam=pts, gdesc=lc._global_descriptor(desc))
        )
    return db


class _Query:
    """Minimal stand-in for a HostFrame keyframe with extracted features."""

    def __init__(self, rng):
        self.id = 10**9
        self.descriptors = (rng.random((200, 256)) < 0.5).astype(np.float32)
        self.keypoints = rng.uniform(0, 100, (200, 2))
        self.kp_depth = rng.uniform(0.5, 3.0, 200)

        class _Cam:
            fx = fy = 100.0
            cx = cy = 50.0

        class _Frame:
            cameras = [_Cam()]

        self.frame = _Frame()


def _answer(cand) -> str:
    return "none" if cand is None else f"kf{cand.kf_id}/{cand.n_inliers}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", nargs="*", type=int, help="database sizes (default 100 300 1000)")
    ap.add_argument("--device", default="cuda", help="torch device to match on (default cuda)")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    sizes = args.sizes or [100, 300, 1000]

    rng = np.random.default_rng(0)
    q = _Query(rng)
    print(f"{'keyframes':>10} {'shortlist ms':>14} {'full-scan ms':>14} {'shortlist loop':>16} {'full-scan loop':>16}")
    for n in sizes:
        ms, answers = [], []
        for k in (5, 0):  # shortlisted vs unfiltered
            cfg = lc.LoopClosureConfig(min_gap=2, max_candidates=k)
            db = build_db(n, cfg, np.random.default_rng(1), device)
            answers.append(_answer(db.query(q)))  # also warms the device
            t0 = time.perf_counter()
            reps = 3 if k else 1
            for _ in range(reps):
                db.query(q)
            ms.append(1e3 * (time.perf_counter() - t0) / reps)
        print(f"{n:>10} {ms[0]:>14.1f} {ms[1]:>14.1f} {answers[0]:>16} {answers[1]:>16}")


if __name__ == "__main__":
    main()
