"""Cells of `BENCHMARK.json` cut to a size the CPU tests can run: the same
files, the sensor scaled down with its intrinsics, few sequences or pairs.
A spare cell (its configuration and traffic files kept in `benchmark/` for
a later cell, not in `BENCHMARK.json`) is built from its files, with no
limits."""

from __future__ import annotations

import copy
import json

from benchmark import harness

SIZES = {  # cell: (height, width, traffic overrides)
    "tum_suite": (120, 160, {"sequences": 3, "frames": 6, "chunk": 4}),
    "kitti_suite": (94, 310, {"sequences": 2, "frames": 5, "chunk": 4}),
    "tum_pairs_b1024": (120, 160, {"pairs": 4}),
}


SPARE = {  # cell: (configuration file under benchmark/, traffic)
    "kitti_suite": ("configs/kitti_00_stereo.json", "suite_s12_street"),
}


def small_cell(name: str, height: int = None, width: int = None, **traffic) -> harness.Cell:
    if name in SPARE:
        conf, mix = SPARE[name]
        cell = harness.Cell(name, 1, json.loads((harness.HERE / conf).read_text()),
                            json.loads((harness.HERE / "traffic" / f"{mix}.json").read_text()), {}, [], [])
    else:
        cell = harness.load_cell(name)
    h, w, over = SIZES[name]
    height, width = height or h, width or w
    config = copy.deepcopy(cell.config)
    s = config["sensor"]
    scale = width / s["width"]
    s.update(height=height, width=width, fx=s["fx"] * scale, fy=s["fy"] * scale, cx=s["cx"] * scale,
             cy=s["cy"] * scale)
    if "max_disparity" in s:
        s["max_disparity"] = 32
    return cell._replace(config=config, traffic={**cell.traffic, **over, **traffic})
