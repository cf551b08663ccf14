"""Per-frame relative-motion statistics of a trajectory file, on the port
(`vslam_tpu_torch`; the same statistics as `examples/dataset_analysis.py`).

Usage: python examples/dataset_analysis_torch.py groundtruth.txt
Prints translational / rotational speed statistics and per-interval motion
percentiles — useful for choosing pyramid depth and prior strength. The
work is numpy only (`core.lie_np`, `io.tum`), so it takes no device.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vslam_tpu_torch.core import lie_np
from vslam_tpu_torch.io import tum


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="TUM trajectory file (timestamp tx ty tz qx qy qz qw)")
    args = ap.parse_args(argv)

    traj = tum.read_trajectory(args.path)
    ts = sorted(traj.keys())
    if len(ts) < 2:
        print("trajectory too short")
        return
    trans, rot, dts = [], [], []
    for a, b in zip(ts[:-1], ts[1:]):
        rel = lie_np.inv(traj[a]) @ traj[b]  # cam->world convention
        xi = lie_np.log(rel)
        dt = b - a
        if dt <= 0:
            continue
        trans.append(np.linalg.norm(xi[:3]))
        rot.append(np.linalg.norm(xi[3:]))
        dts.append(dt)
    trans = np.asarray(trans)
    rot = np.asarray(rot)
    dts = np.asarray(dts)

    def stats(x, unit):
        return (
            f"mean {x.mean():.4f}{unit}  median {np.median(x):.4f}{unit}  "
            f"p95 {np.percentile(x, 95):.4f}{unit}  max {x.max():.4f}{unit}"
        )

    print(f"frames: {len(ts)}  span: {ts[-1]-ts[0]:.1f}s  mean dt: {dts.mean()*1e3:.1f}ms")
    print("per-interval translation:", stats(trans, "m"))
    print("per-interval rotation:   ", stats(rot, "rad"))
    print("translational speed:     ", stats(trans / dts, "m/s"))
    print("rotational speed:        ", stats(rot / dts, "rad/s"))


if __name__ == "__main__":
    main()
