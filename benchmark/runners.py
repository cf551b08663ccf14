"""The system under test, driven as a traffic mix asks.

A traffic file's ``kind`` names its runner here:

- ``suite``: `vslam_tpu_torch.parallel.sequences.MultiSequenceOdometry.
  run_staged`, the lock-step scan of S sequences, over inputs staged on the
  device in set-up; one unit of work is one pass over every frame of every
  sequence, and its results come back to the host before the pass returns.
- ``pairs``: `vslam_tpu_torch.parallel.batched.align_pairs` on B pairs whose
  frames (pyramids) were built in set-up; each call starts from the identity
  plus 1e-30 times the previous call's result, so every call depends on the
  one before it, and nothing waits between calls; the last call's result is
  fetched when the window closes.

Each runner builds the program from the configuration file, renders its
inputs (`scenes`), warms up the shapes of its traffic, and then runs units of
work. It imports the program only here.
"""

from __future__ import annotations

import numpy as np
import torch

from . import scenes

__all__ = ["alignment_config", "sequential_config", "SuiteRunner", "PairRunner", "RUNNERS"]


def alignment_config(config: dict):
    from vslam_tpu_torch.alignment.ic import AlignmentConfig
    from vslam_tpu_torch.solvers import LossConfig, SolverConfig

    a = config["alignment"]
    return AlignmentConfig(
        min_gradient=float(a["min_gradient"]),
        solver=SolverConfig(max_iterations=int(a["max_iterations"]), min_step_size=float(a["min_step_size"]),
                            min_relative_reduction=a["min_relative_reduction"]),
        loss=LossConfig(a["loss"]),
        include_prior=bool(a["include_prior"]),
        prior_weight=float(a["prior_weight"]),
        interpolation=a["interpolation"],
        max_points=int(a["max_points"]),
        sampler=a["sampler"],
        image_dtype=a["image_dtype"],
    )


def sequential_config(config: dict):
    from vslam_tpu_torch.odometry.sequential import SequentialConfig

    s, o = config["sensor"], config["odometry"]
    stereo = s["kind"] == "stereo"
    return SequentialConfig(
        alignment=alignment_config(config),
        depth_scale=1.0 if stereo else float(s["depth_scale_m"]),
        stereo_baseline=float(s["baseline_m"]) if stereo else 0.0,
        stereo_max_disparity=int(s.get("max_disparity", 96)),
        n_levels=int(o["levels"]),
        prediction_model=o["prediction"],
        kf_period=int(o["kf_period"]),
        kf_max_translation=float(o["kf_max_translation_m"]),
        include_key_frame=bool(o["include_key_frame"]),
    )


def _camera(config: dict, device):
    from vslam_tpu_torch.core.camera import Camera

    s = config["sensor"]
    return Camera.create(s["fx"], s["fy"], s["cx"], s["cy"], device=device)


class SuiteRunner:
    """S sequences advanced in lock-step, a pass at a time."""

    fetches_each = True  # a pass returns its answers on the host

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from vslam_tpu_torch.parallel.sequences import MultiSequenceOdometry, StagedSuiteChunk

        self.config, self.traffic = config, traffic
        self.inputs = scenes.suite_inputs(config, traffic, seed, device)
        S, F = int(traffic["sequences"]), int(traffic["frames"])
        dt = self.inputs.dt_ns
        self.odo = MultiSequenceOdometry([_camera(config, device)] * S, sequential_config(config),
                                         chunk=int(traffic["chunk"]))
        i0, d0 = (x.cpu().numpy() for x in self.inputs.first)
        if d0.dtype == np.int16:
            d0 = d0.view(np.uint16)  # the sensor's type; the scan uploads its bits
        self.firsts = [(0, i0[s], d0[s]) for s in range(S)]
        self.chunks, k0 = [], 1
        for a, b in self.inputs.chunks:
            K = a.shape[1]
            stamps = [[(k0 + j) * dt for j in range(K)] for _ in range(S)]
            self.chunks.append(StagedSuiteChunk(stamps, a, b, torch.full((S, K), dt / 1e9, device=device), None))
            k0 += K
        self.units_per_run = S * F
        self.steps_per_run = F - 1
        self.run()  # warm-up: builds the kernels and every shape of the mix

    def run(self):
        return self.odo.run_staged(self.firsts, self.chunks)

    @staticmethod
    def answer(out):
        """(S, F, 4, 4) f64 world->camera poses of one pass."""
        return np.stack([np.stack([T for _, T, _ in seq]) for seq in out])

    def release(self):
        self.odo = self.chunks = self.firsts = None


class PairRunner:
    """B independent pairs aligned in each call."""

    fetches_each = False  # only the window's last call is fetched

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from vslam_tpu_torch.core import se3
        from vslam_tpu_torch.core.frame import create_frame

        self.config, self.traffic = config, traffic
        self.inputs = scenes.pair_inputs(config, traffic, seed, device)
        B = int(traffic["pairs"])
        cam = _camera(config, device)
        step = float(config["sensor"]["depth_scale_m"])
        levels = int(config["odometry"]["levels"])

        def frames(images):
            inten, bits = images
            depth = (bits.to(torch.int32) & 0xFFFF).to(torch.float32) * step
            return create_frame(inten.to(torch.float32), depth, cam, n_levels=levels)

        self.ref, self.cur = frames(self.inputs.ref), frames(self.inputs.cur)
        self.rel0 = se3.identity((B,), device=device)
        self.x_pred = torch.zeros(B, 6, device=device)
        self.cfg = alignment_config(config)
        self.units_per_run = B
        self.steps_per_run = 1
        self.last = self.rel0
        self.fetch(self.run())  # warm-up

    def run(self):
        """One call, chained to the previous one; nothing waits."""
        from vslam_tpu_torch.core.se3 import SE3
        from vslam_tpu_torch.parallel.batched import align_pairs

        r = self.last
        rel_in = SE3(self.rel0.R + 1e-30 * r.R, self.rel0.t + 1e-30 * r.t)
        self.last, _, _ = align_pairs(self.ref, self.cur, rel_in, self.x_pred, self.cfg)
        return self.last

    @staticmethod
    def answer(T):
        return T

    @staticmethod
    def fetch(rel):
        """(B, 4, 4) f64 of a call's result, on the host: waits for it."""
        T = np.zeros((rel.t.shape[0], 4, 4))
        T[:, :3, :3] = rel.R.double().cpu().numpy()
        T[:, :3, 3] = rel.t.double().cpu().numpy()
        T[:, 3, 3] = 1.0
        return T

    def release(self):
        self.ref = self.cur = None


RUNNERS = {"suite": SuiteRunner, "pairs": PairRunner}
