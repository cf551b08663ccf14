"""The odometry sub-bench of the port's bench (`vslam_tpu_torch.bench.
odometry`) against the JAX package's `SequentialOdometry`, on the CPU.

At 8 frames, 60x80 (fx 65.625), chunk 4, `bench.py`'s odometry profile on
the `gather` sampler (no Pallas kernel on the JAX side; the port's
`fused_gn` is held to the JAX kernel by `tests/test_torch_sequential.py`),
the smooth trajectory rebuilt with the JAX package's `io/synthetic` and
`lie_np` as `bench.py:570-586` builds it: the ATE the port's function
reports equals the JAX run's within ATE_TOL, and its gate passed. Kept
apart from `tests/test_torch_bench.py` so that each file stays under a
minute on one worker.
"""

import numpy as np

from vslam_tpu.alignment.ic import AlignmentConfig as JAlignmentConfig
from vslam_tpu.core import lie_np as jlie
from vslam_tpu.core.camera import Camera as JCamera
from vslam_tpu.eval import metrics as jmetrics
from vslam_tpu.io import synthetic as jsyn
from vslam_tpu.odometry import sequential as jseq
from vslam_tpu.solvers import SolverConfig as JSolverConfig
from vslam_tpu_torch import bench
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

H, W = 60, 80
ATE_TOL = 1e-4  # metres, over 8 frames


def test_odometry_ate_matches_jax():
    frames, chunk = 8, 4
    line = bench.odometry(frames=frames, chunk=chunk, height=H, width=W, trajectory="synthetic", sampler="gather",
                          device="cpu")

    fx = 525.0 * W / 640
    K = jsyn.camera_matrix(fx, fx, (W - 1) / 2, (H - 1) / 2)
    poses = jsyn.smooth_trajectory(frames, trans_amp=0.08, rot_amp=0.03)
    p0i = jlie.inv(poses[0])
    poses = [p @ p0i for p in poses]
    dt_ns = int(1e9 / 30)
    stream = []
    for i, p in enumerate(poses):  # `bench.py:574-586`
        inten, depth = jsyn.render(K, p, (H, W))
        stream.append((i * dt_ns, np.clip(np.round(inten), 0, 255).astype(np.uint8),
                       np.clip(np.round(depth * 5000.0), 0, 65535).astype(np.uint16)))
    cfg = jseq.SequentialConfig(
        alignment=JAlignmentConfig(
            min_gradient=30.0,
            solver=JSolverConfig(max_iterations=100, min_step_size=1e-11, min_relative_reduction=1e-4),
            include_prior=True, interpolation="bilinear", sampler="gather", image_dtype="bfloat16",
            max_points=2048),
        depth_scale=1.0 / 5000.0, n_levels=3, kf_period=5)
    results = jseq.SequentialOdometry(JCamera.create(fx, fx, (W - 1) / 2, (H - 1) / 2), cfg,
                                      chunk=chunk).run(iter(stream))
    gt = {i * dt_ns / 1e9: jlie.inv(p) for i, p in enumerate(poses)}
    ate, n = jmetrics.ate_rmse(gt, {t / 1e9: jlie.inv(p) for t, p, _ in results})
    assert n == frames
    assert abs(line["odometry_ate_m"] - ate) <= ATE_TOL
    assert line["odometry_fps"] > 0 and line["odometry_stream_fps"] > 0  # the gate (ATE < 0.01 m) passed
