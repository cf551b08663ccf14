"""The whole-level GN CUDA kernel against its plain PyTorch version, on the
card. Marked `cuda`; skips where torch sees no CUDA device. The machine with
the card has no JAX, which tests/conftest.py imports, so run it there as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernel is compiled with -fmad=false and the plain version evaluates the
kernel's expressions in its order (thread-strided sums, a shuffle tree,
warps in sequence), so the two are compared bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

from vslam_tpu_torch.alignment import fused_solve
from vslam_tpu_torch.alignment import ic
from vslam_tpu_torch.alignment.aligner import stack_frames
from vslam_tpu_torch.core import lie_np
from vslam_tpu_torch.core.camera import Camera
from vslam_tpu_torch.core.frame import create_frame
from vslam_tpu_torch.core.se3 import SE3
from vslam_tpu_torch.io import synthetic
from vslam_tpu_torch.solvers import SolverConfig

pytestmark = pytest.mark.cuda

H, W = 60, 80
FX = 525.0 * W / 640


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _problem(device, B, F, max_points, seed=0):
    K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    cam = Camera.create(FX, FX, (W - 1) / 2, (H - 1) / 2, device=device)
    rng = np.random.default_rng(seed)
    refs, curs, rels = [], [], []
    for b in range(B):
        xi = np.concatenate([rng.uniform(-0.02, 0.02, 3), rng.uniform(-0.01, 0.01, 3)])
        scene = synthetic.default_scene(seed=b)
        ref_f = []
        for f in range(F):
            pose = lie_np.exp(xi * f / F)
            inten, depth = synthetic.render(K, pose, (H, W), scene)
            ref_f.append(create_frame(torch.as_tensor(inten, device=device),
                                      torch.as_tensor(depth, device=device), cam, n_levels=1))
            rels.append(lie_np.relative(pose, lie_np.exp(0.9 * xi)))
        refs.append(stack_frames(ref_f))
        inten, depth = synthetic.render(K, lie_np.exp(xi), (H, W), scene)
        curs.append(create_frame(torch.as_tensor(inten, device=device),
                                 torch.as_tensor(depth, device=device), cam, n_levels=1))
    ref, cur = stack_frames(refs), stack_frames(curs)
    data = ic.precompute_level(ref.intensity[0], ref.dIx[0], ref.dIy[0], ref.depth[0],
                               ic._first_camera(ref.cameras[0], B), 10.0, max_points=max_points)
    rels = np.stack(rels).reshape(B, F, 4, 4)
    rel0 = SE3(torch.as_tensor(rels[..., :3, :3], dtype=torch.float32, device=device),
               torch.as_tensor(rels[..., :3, 3], dtype=torch.float32, device=device))
    x_pred = torch.as_tensor(np.stack([lie_np.log(r) for r in rels.reshape(-1, 4, 4)]).reshape(B, F, 6),
                             dtype=torch.float32, device=device)
    return data, rel0, cur.intensity[0], cur.cameras[0], x_pred


@pytest.mark.parametrize(
    "F,max_points,interpolation,image_dtype,prior,max_iterations",
    [
        (1, 300, "nearest", "float32", False, 30),  # P not a multiple of 256
        (1, 100, "nearest", "bfloat16", True, 30),  # P < one block of threads
        (2, 1200, "bilinear", "float32", True, 30),
        (3, 600, "bilinear", "bfloat16", True, 30),  # more frames than the slice uses
        (1, 600, "nearest", "float32", False, 1),
        (1, 600, "nearest", "float32", False, 0),
    ],
)
def test_kernel_equals_plain_bit_for_bit(device, F, max_points, interpolation, image_dtype, prior,
                                         max_iterations):
    data, rel0, img, cam, x_pred = _problem(device, 5, F, max_points)
    cfg = ic.AlignmentConfig(
        min_gradient=10.0, solver=SolverConfig(max_iterations, 1e-11, min_relative_reduction=1e-4),
        include_prior=prior, prior_weight=(FX / 525.0) ** 2, interpolation=interpolation,
        sampler="fused_gn", image_dtype=image_dtype, max_points=max_points,
    )
    xp = x_pred if prior else None
    before = fused_solve.LAUNCHES
    rel_k, res_k = fused_solve.solve_level_fused(data, rel0, img, cam, cfg, xp)
    rel_p, res_p = fused_solve.solve_level_fused_plain(data, rel0, img, cam, cfg, xp)
    torch.cuda.synchronize()
    assert fused_solve.LAUNCHES == before + 1
    assert res_k.iterations.tolist() == res_p.iterations.tolist()
    if max_iterations >= 30:
        assert int(res_k.iterations.max()) > 1
    for a, b in [(rel_k.R, rel_p.R), (rel_k.t, rel_p.t), (res_k.A, res_p.A), (res_k.b, res_p.b),
                 (res_k.chi2, res_p.chi2), (res_k.valid, res_p.valid),
                 (res_k.chi2_history, res_p.chi2_history), (res_k.step_history, res_p.step_history)]:
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_kernel_wrapper_refuses_bad_inputs(device):
    data, rel0, img, cam, _ = _problem(device, 2, 1, 200)
    cfg = ic.AlignmentConfig(sampler="fused_gn", max_points=200)
    before = fused_solve.LAUNCHES
    bad = data._replace(pcl=data.pcl.transpose(-1, -2).contiguous().transpose(-1, -2))
    with pytest.raises(ValueError, match="contiguous"):
        fused_solve.solve_level_fused(bad, rel0, img, cam, cfg, None)
    with pytest.raises(ValueError, match="float32"):
        fused_solve.solve_level_fused(data._replace(J=data.J.double()), rel0, img, cam, cfg, None)
    with pytest.raises(ValueError, match="shape"):
        fused_solve.solve_level_fused(data, SE3(rel0.R[:1], rel0.t[:1]), img, cam, cfg, None)
    assert fused_solve.LAUNCHES == before


def test_align_pairs_launches_once_per_level(device):
    from vslam_tpu_torch.parallel.batched import align_pairs

    K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    cam = Camera.create(FX, FX, (W - 1) / 2, (H - 1) / 2, device=device)
    xi = np.array([0.01, -0.01, 0.005, 0.004, -0.003, 0.002])
    frames = []
    for pose in (np.eye(4), lie_np.exp(xi)):
        inten, depth = synthetic.render(K, pose, (H, W))
        frames.append(create_frame(torch.as_tensor(inten, device=device)[None],
                                   torch.as_tensor(depth, device=device)[None], cam, n_levels=3))
    cfg = ic.AlignmentConfig(min_gradient=10.0, sampler="fused_gn", max_points=2048,
                             include_prior=False, interpolation="bilinear")
    rel0 = SE3(torch.eye(3, device=device)[None], torch.zeros(1, 3, device=device))
    before = fused_solve.LAUNCHES
    rel, cov, valid = align_pairs(frames[0], frames[1], rel0, None, cfg)
    plain = align_pairs(frames[0], frames[1], rel0, None, dataclasses.replace(cfg, sampler="gather"))
    torch.cuda.synchronize()
    assert fused_solve.LAUNCHES == before + 3
    assert bool(valid[0]) and bool(torch.isfinite(cov).all())
    T = np.eye(4)
    T[:3, :3] = rel.R[0].double().cpu().numpy()
    T[:3, 3] = rel.t[0].double().cpu().numpy()
    assert np.linalg.norm(lie_np.log(T) - xi) < 0.01
    torch.testing.assert_close(rel.t, plain[0].t, rtol=0, atol=1e-3)
