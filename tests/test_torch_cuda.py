"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the whole-level GN kernel (quadratic and robust entries), the
per-iteration sample and NE kernels and the mxu sampler. Marked `cuda`; skips where torch sees no CUDA device. The machine with
the card has no JAX, which tests/conftest.py imports, so run it there as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernels are compiled with -fmad=false and the plain versions evaluate
the kernels' expressions in their order (thread-strided sums, a shuffle
tree, warps in sequence), so the two are compared bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

from vslam_tpu_torch.alignment import fused_ne, fused_solve, pallas_kernels
from vslam_tpu_torch.alignment import ic
from vslam_tpu_torch.alignment.aligner import stack_frames
from vslam_tpu_torch.core import lie_np
from vslam_tpu_torch.core.camera import Camera
from vslam_tpu_torch.core.frame import create_frame
from vslam_tpu_torch.core.se3 import SE3
from vslam_tpu_torch.io import synthetic
from vslam_tpu_torch.solvers import LossConfig, SolverConfig

pytestmark = pytest.mark.cuda

H, W = 60, 80
FX = 525.0 * W / 640


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _problem(device, B, F, max_points, seed=0, integer=False):
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
            inten = np.round(inten) if integer else inten
            ref_f.append(create_frame(torch.as_tensor(inten, device=device),
                                      torch.as_tensor(depth, device=device), cam, n_levels=1))
            rels.append(lie_np.relative(pose, lie_np.exp(0.9 * xi)))
        refs.append(stack_frames(ref_f))
        inten, depth = synthetic.render(K, lie_np.exp(xi), (H, W), scene)
        inten = np.round(inten) if integer else inten
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


ROBUST_CASES = [("Huber", "reference"), ("Tukey", "reference"), ("tdistribution", "reference"),
                ("Huber", "mad"), ("Tukey", "mad"), ("Huber", "mean"), ("Tukey", "mean")]


@pytest.mark.parametrize(
    "function,scaler,F,interpolation,image_dtype,prior",
    [(f, s, 1, "nearest", "float32", False) for f, s in ROBUST_CASES]
    + [("Huber", "reference", 2, "nearest", "bfloat16", True),
       ("tdistribution", "reference", 3, "bilinear", "float32", True),
       ("Tukey", "mad", 1, "bilinear", "bfloat16", False)],
)
def test_robust_kernel_equals_plain_bit_for_bit(device, function, scaler, F, interpolation,
                                                image_dtype, prior):
    data, rel0, img, cam, x_pred = _problem(device, 5, F, 300)
    cfg = ic.AlignmentConfig(
        min_gradient=10.0, solver=SolverConfig(30, 1e-11, min_relative_reduction=1e-4),
        loss=LossConfig(function, scaler=scaler), include_prior=prior,
        prior_weight=(FX / 525.0) ** 2, interpolation=interpolation, sampler="fused_gn",
        image_dtype=image_dtype, max_points=300,
    )
    xp = x_pred if prior else None
    before = (fused_solve.LAUNCHES, fused_solve.ROBUST_LAUNCHES)
    rel_k, res_k = fused_solve.solve_level_fused(data, rel0, img, cam, cfg, xp)
    rel_p, res_p = fused_solve.solve_level_fused_plain(data, rel0, img, cam, cfg, xp)
    torch.cuda.synchronize()
    assert (fused_solve.LAUNCHES, fused_solve.ROBUST_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert res_k.iterations.tolist() == res_p.iterations.tolist()
    assert int(res_k.iterations.max()) > 1
    for a, b in [(rel_k.R, rel_p.R), (rel_k.t, rel_p.t), (res_k.A, res_p.A), (res_k.b, res_p.b),
                 (res_k.chi2, res_p.chi2), (res_k.valid, res_p.valid),
                 (res_k.chi2_history, res_p.chi2_history), (res_k.step_history, res_p.step_history)]:
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


_PROBLEMS = {}


def _cached_problem(device, B, F, max_points, integer=False):
    key = (B, F, max_points, integer)
    if key not in _PROBLEMS:
        _PROBLEMS[key] = _problem(device, B, F, max_points, integer=integer)
    return _PROBLEMS[key]


def _assert_solves_equal(out_k, out_p):
    (rel_k, res_k), (rel_p, res_p) = out_k, out_p
    assert res_k.iterations.tolist() == res_p.iterations.tolist()
    for a, b in [(rel_k.R, rel_p.R), (rel_k.t, rel_p.t), (res_k.A, res_p.A), (res_k.b, res_p.b),
                 (res_k.chi2, res_p.chi2), (res_k.valid, res_p.valid),
                 (res_k.chi2_history, res_p.chi2_history), (res_k.step_history, res_p.step_history)]:
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("B,F,max_points,integer", [(1, 2, 300, False), (64, 1, 300, False),
                                                    (3, 2, 100, False), (1, 2, 300, True)],
                         ids=["B1-F2", "B64-F1", "P-below-one-block-per-CTA", "B1-F2-integer-images"])
@pytest.mark.parametrize("function,scaler", ROBUST_CASES)
def test_robust_kernel_equals_plain_at_the_main_path_batches(device, function, scaler, B, F, max_points,
                                                             integer):
    """Every loss x scaler at the robust profile's stacking (B = 1, F = 2),
    at align_pairs' batch (B = 64, F = 1), with fewer points than
    256 x CTAS, so some blocks of a cluster hold few or no points, and on
    integer-valued images (integer residuals, whose median buckets end the
    select early): bit for bit."""
    data, rel0, img, cam, x_pred = _cached_problem(device, B, F, max_points, integer)
    assert max_points > 100 or data.templ.shape[-1] < 256 * fused_solve.CTAS
    cfg = ic.AlignmentConfig(
        min_gradient=10.0, solver=SolverConfig(30, 1e-11, min_relative_reduction=1e-4),
        loss=LossConfig(function, scaler=scaler), include_prior=F > 1,
        prior_weight=(FX / 525.0) ** 2, interpolation="nearest", sampler="fused_gn",
        image_dtype="bfloat16", max_points=max_points,
    )
    xp = x_pred if F > 1 else None
    out_k = fused_solve.solve_level_fused(data, rel0, img, cam, cfg, xp)
    out_p = fused_solve.solve_level_fused_plain(data, rel0, img, cam, cfg, xp)
    torch.cuda.synchronize()
    _assert_solves_equal(out_k, out_p)


@pytest.mark.parametrize("loss", ["None", "Huber"])
def test_kernel_with_an_empty_mask_equals_plain(device, loss):
    """No interest point at all: the solve stops at its first iteration,
    kernel and plain alike."""
    data, rel0, img, cam, _ = _cached_problem(device, 5, 2, 300)
    data = data._replace(mask=torch.zeros_like(data.mask), n_constraints=torch.zeros_like(data.n_constraints))
    cfg = ic.AlignmentConfig(min_gradient=10.0, loss=LossConfig(loss), sampler="fused_gn", max_points=300)
    out_k = fused_solve.solve_level_fused(data, rel0, img, cam, cfg, None)
    out_p = fused_solve.solve_level_fused_plain(data, rel0, img, cam, cfg, None)
    torch.cuda.synchronize()
    _assert_solves_equal(out_k, out_p)
    assert not bool(out_k[1].valid.any())


@pytest.mark.parametrize("function", ["Huber", "Tukey", "tdistribution"])
def test_robust_kernel_with_the_residual_cache_in_global_memory_equals_plain(device, function):
    """A frame of 2^20 points: a block's share of its residual cache does
    not fit in shared memory, so the robust entry keeps the cache in a
    global scratch buffer. It solves, bit for bit against the plain version,
    as the quadratic entry (which keeps no cache) does."""
    import ctypes

    from vslam_tpu_torch import _build

    B, F, P = 1, 1, 1 << 20
    need, limit = ctypes.c_int(0), ctypes.c_int(0)
    assert _build.library().vslam_solve_level_smem(F, P, 1, ctypes.byref(need), ctypes.byref(limit)) == 0
    assert need.value > limit.value  # the shared cache does not fit
    g = torch.Generator(device=device).manual_seed(0)
    data = ic.ICLevelData(
        pcl=torch.rand(B, F, P, 3, device=device, generator=g) + torch.tensor([0.0, 0.0, 1.0], device=device),
        J=torch.randn(B, F, P, 6, device=device, generator=g),
        templ=torch.rand(B, F, P, device=device, generator=g) * 255,
        mask=torch.rand(B, F, P, device=device, generator=g) < 0.9,
        n_constraints=torch.zeros(B, F, device=device))
    data = data._replace(n_constraints=data.mask.sum(-1).float())
    rel0 = SE3(torch.eye(3, device=device).expand(B, F, 3, 3).contiguous(), torch.zeros(B, F, 3, device=device))
    cam = Camera(*(torch.full((B,), v, device=device) for v in (10.0, 10.0, 7.5, 5.5)))
    img = torch.rand(B, 12, 16, device=device, generator=g) * 255
    before = (fused_solve.LAUNCHES, fused_solve.ROBUST_LAUNCHES)
    cfg = ic.AlignmentConfig(sampler="fused_gn", loss=LossConfig(function),
                             solver=SolverConfig(4, 1e-11, min_relative_reduction=1e-4))
    out_k = fused_solve.solve_level_fused(data, rel0, img, cam, cfg, None)
    out_p = fused_solve.solve_level_fused_plain(data, rel0, img, cam, cfg, None)
    torch.cuda.synchronize()
    assert (fused_solve.LAUNCHES, fused_solve.ROBUST_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert int(out_k[1].iterations.max()) >= 1
    _assert_solves_equal(out_k, out_p)
    fused_solve.solve_level_fused(data, rel0, img, cam, dataclasses.replace(cfg, loss=LossConfig()), None)
    torch.cuda.synchronize()
    assert fused_solve.LAUNCHES == before[0] + 2


def test_sampler_takes_more_rows_than_the_grid_y_extent(device):
    """B x F = 70,000 (pair, frame) rows of 8 points at 12x16, above the
    65,535 rows of one grid's y extent: bit for bit against the plain
    version."""
    B, F, P, Hi, Wi = 35000, 2, 8, 12, 16
    g = torch.Generator(device=device).manual_seed(3)
    z = 1.0 + torch.rand(B, F, P, 1, device=device, generator=g)
    xy = (torch.rand(B, F, P, 2, device=device, generator=g) - 0.5) * z
    mask = torch.rand(B, F, P, device=device, generator=g) < 0.9
    data = ic.ICLevelData(pcl=torch.cat([xy, z], dim=-1).contiguous(), J=torch.zeros(B, F, P, 6, device=device),
                          templ=torch.zeros(B, F, P, device=device), mask=mask,
                          n_constraints=mask.sum(-1).float())
    rel = SE3(torch.eye(3, device=device).expand(B, F, 3, 3).contiguous(),
              torch.full((B, F, 3), 0.01, device=device))
    cam = Camera(*(torch.full((B,), v, device=device) for v in (10.0, 10.0, (Wi - 1) / 2, (Hi - 1) / 2)))
    img = torch.rand(B, Hi, Wi, device=device, generator=g) * 255
    before = fused_ne.SAMPLE_LAUNCHES
    got = fused_ne.fused_level_sample(data, rel, img, cam, "bilinear")
    want = fused_ne.fused_level_sample_plain(data, rel, img, cam, "bilinear")
    torch.cuda.synchronize()
    assert fused_ne.SAMPLE_LAUNCHES == before + 1
    assert 0.3 < got[1].float().mean().item() < 1.0
    assert bool(got[1][-1].any())  # the last rows were sampled too
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("F", [1, 2])
@pytest.mark.parametrize("loss", ["None", "Huber"])
def test_kernel_reading_unstaged_level_data_equals_plain(device, loss, F):
    """Frames of 2^15 points: the level data of a block's share does not fit
    in shared memory beside the kernel's state (and, robust, the residual
    cache), so the kernel reads pcl, J, template and mask from global memory
    every iteration. Bit for bit against the plain version."""
    import ctypes

    from vslam_tpu_torch import _build

    B, P, Hi, Wi = 2, 1 << 15, 120, 160
    need, limit = ctypes.c_int(0), ctypes.c_int(0)
    assert _build.library().vslam_solve_level_smem(F, P, int(loss != "None"), ctypes.byref(need),
                                                   ctypes.byref(limit)) == 0
    # staging adds 12 + 24 + 4 + 1 bytes per point of each frame's share
    share = -(-P // (16 * fused_solve.CTAS)) * 16
    assert need.value <= limit.value < need.value + 41 * F * share
    g = torch.Generator(device=device).manual_seed(F)
    xy = torch.rand(B, F, P, 2, device=device, generator=g) - 0.5
    z = 1.0 + torch.rand(B, F, P, 1, device=device, generator=g)
    data = ic.ICLevelData(
        pcl=torch.cat([xy * z, z], dim=-1).contiguous(),
        J=torch.randn(B, F, P, 6, device=device, generator=g),
        templ=torch.rand(B, F, P, device=device, generator=g) * 255,
        mask=torch.rand(B, F, P, device=device, generator=g) < 0.9,
        n_constraints=torch.zeros(B, F, device=device))
    data = data._replace(n_constraints=data.mask.sum(-1).float())
    rel0 = SE3(torch.eye(3, device=device).expand(B, F, 3, 3).contiguous(), torch.zeros(B, F, 3, device=device))
    cam = Camera(*(torch.full((B,), v, device=device) for v in (100.0, 100.0, (Wi - 1) / 2, (Hi - 1) / 2)))
    img = torch.rand(B, Hi, Wi, device=device, generator=g) * 255
    cfg = ic.AlignmentConfig(min_gradient=10.0, sampler="fused_gn", loss=LossConfig(loss),
                             solver=SolverConfig(8, 1e-11, min_relative_reduction=1e-4), image_dtype="float32")
    before = fused_solve.LAUNCHES
    out_k = fused_solve.solve_level_fused(data, rel0, img, cam, cfg, None)
    out_p = fused_solve.solve_level_fused_plain(data, rel0, img, cam, cfg, None)
    torch.cuda.synchronize()
    assert fused_solve.LAUNCHES == before + 1
    assert int(out_k[1].iterations.max()) >= 1
    _assert_solves_equal(out_k, out_p)


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


def test_sharded_tracking_step_in_an_nccl_group_of_one_equals_tracking_step(device, tmp_path):
    """`sharded_tracking_step` in an NCCL group of one (the default backend
    on the card) solves the whole batch as `tracking_step` does, bit for
    bit (Huber, `fused_gn`: kernel 1b), and its `frac` is the mean of valid."""
    import torch.distributed as dist

    from vslam_tpu_torch.core import se3
    from vslam_tpu_torch.kalman import ekf_se3
    from vslam_tpu_torch.parallel import batched, multihost

    B = 4
    K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    cam = Camera.create(FX, FX, (W - 1) / 2, (H - 1) / 2, device=device)
    rng = np.random.default_rng(3)
    refs, curs = [], []
    for b in range(B):
        xi = np.concatenate([rng.uniform(-0.01, 0.01, 3), rng.uniform(-0.005, 0.005, 3)])
        for lst, pose in ((refs, np.eye(4)), (curs, lie_np.exp(xi))):
            inten, depth = synthetic.render(K, pose, (H, W), synthetic.default_scene(seed=b))
            lst.append(create_frame(torch.as_tensor(inten, device=device), torch.as_tensor(depth, device=device),
                                    cam, n_levels=2))
    ref, cur = stack_frames(refs), stack_frames(curs)
    cfg = ic.AlignmentConfig(min_gradient=10.0, loss=LossConfig("Huber"), sampler="fused_gn", max_points=512,
                             prior_weight=(FX / 525.0) ** 2)
    ekf0 = ekf_se3.init(pose=se3.identity((B,), device=device))
    dt = torch.full((B,), 1.0 / 30.0, device=device)
    want = batched.tracking_step(ekf0, ref, cur, dt, cfg)
    assert multihost.initialize(f"file://{tmp_path}/store", 1, 0) == torch.device("cuda", 0)
    try:
        assert dist.get_backend() == "nccl"
        mesh = batched.make_mesh()
        before = fused_solve.ROBUST_LAUNCHES
        got = batched.sharded_tracking_step(mesh, cfg)(*batched.shard_batch((ekf0, ref, cur, dt), mesh))
        torch.cuda.synchronize()
        assert fused_solve.ROBUST_LAUNCHES == before + 2
    finally:
        dist.destroy_process_group()
    for g, w in zip((*got[0], *got[1], got[2]), (*want[0], *want[1], want[2])):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert float(got[3]) == float(want[2].float().mean())


@pytest.mark.parametrize(
    "F,max_points,interpolation,image_dtype",
    [
        (1, 300, "nearest", "float32"),  # P not a multiple of 256
        (1, 100, "bilinear", "bfloat16"),  # P < one block of threads
        (2, 1200, "bilinear", "float32"),
        (2, 600, "nearest", "bfloat16"),
        (3, 600, "bilinear", "bfloat16"),
    ],
)
def test_fused_ne_kernels_equal_plain_bit_for_bit(device, F, max_points, interpolation, image_dtype):
    data, rel, img, cam, _ = _problem(device, 5, F, max_points)
    if image_dtype == "bfloat16":
        img = img.to(torch.bfloat16)
    args = (data, rel, img, cam, interpolation)
    before = (fused_ne.SAMPLE_LAUNCHES, fused_ne.NE_LAUNCHES)
    sample_k, sample_p = fused_ne.fused_level_sample(*args), fused_ne.fused_level_sample_plain(*args)
    ne_k, ne_p = fused_ne.fused_level_ne(*args), fused_ne.fused_level_ne_plain(*args)
    torch.cuda.synchronize()
    assert (fused_ne.SAMPLE_LAUNCHES, fused_ne.NE_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert 0.3 < sample_k[1].float().mean().item() < 1.0
    for a, b in zip(sample_k + ne_k, sample_p + ne_p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _random_level(device, B, F, P, seed, pcl_offset=0):
    """Random level data on a 120x160 image, about 90 % of the points in the
    interest mask and most of those in view; the pcl (and mask) storage
    starts ``pcl_offset`` elements into its allocation."""
    Hi, Wi = 120, 160
    g = torch.Generator(device=device).manual_seed(seed)
    z = 1.0 + torch.rand(B, F, P, 1, device=device, generator=g)
    xy = (torch.rand(B, F, P, 2, device=device, generator=g) - 0.5) * 1.6 * z
    pcl = torch.empty(B * F * P * 3 + pcl_offset, device=device)[pcl_offset:].view(B, F, P, 3)
    pcl.copy_(torch.cat([xy, z], dim=-1))
    mask = torch.empty(B * F * P + pcl_offset, dtype=torch.bool, device=device)[pcl_offset:].view(B, F, P)
    mask.copy_(torch.rand(B, F, P, device=device, generator=g) < 0.9)
    data = ic.ICLevelData(pcl=pcl, J=torch.randn(B, F, P, 6, device=device, generator=g),
                          templ=torch.rand(B, F, P, device=device, generator=g) * 255, mask=mask,
                          n_constraints=mask.sum(-1).float())
    angle = 0.002 * torch.arange(B * F, device=device, dtype=torch.float32).reshape(B, F)
    R = torch.zeros(B, F, 3, 3, device=device)
    R[..., 0, 0] = R[..., 1, 1] = torch.cos(angle)
    R[..., 0, 1], R[..., 1, 0] = -torch.sin(angle), torch.sin(angle)
    R[..., 2, 2] = 1.0
    rel = SE3(R, torch.full((B, F, 3), 0.01, device=device))
    cam = Camera(*(torch.full((B,), v, device=device) for v in (100.0, 100.0, (Wi - 1) / 2, (Hi - 1) / 2)))
    img = torch.rand(B, Hi, Wi, device=device, generator=g) * 255
    return data, rel, img, cam


@pytest.mark.parametrize("B,F,P,pcl_offset", [(3, 2, 13, 0), (2, 1, 1, 0), (64, 1, 1920, 0), (3, 2, 1203, 1)],
                         ids=["P-below-16-per-CTA", "P-1", "level-0-shape", "pcl-off-a-16-byte-boundary"])
@pytest.mark.parametrize("interpolation,image_dtype", [("nearest", torch.bfloat16), ("bilinear", torch.float32)])
def test_fused_ne_kernels_equal_plain_at_edge_shapes(device, B, F, P, pcl_offset, interpolation, image_dtype):
    """Shapes the redesigned kernels split unevenly: fewer than 16 points a
    frame, a frame of one point (both on one NE CTA), align_pairs' finest
    level (B = 64, F = 1, P = 1920, on the NE cluster), and pcl and mask
    storage that starts 4 bytes off a 16-byte boundary with P odd and above
    the cluster's threshold, so the NE's vector loads of J and, with more
    points per thread, the sampler's, fall back to narrower ones. Bit for
    bit."""
    data, rel, img, cam = _random_level(device, B, F, P, seed=P, pcl_offset=pcl_offset)
    assert data.pcl.data_ptr() % 16 == 4 * pcl_offset
    args = (data, rel, img.to(image_dtype), cam, interpolation)
    before = (fused_ne.SAMPLE_LAUNCHES, fused_ne.NE_LAUNCHES)
    sample_k, sample_p = fused_ne.fused_level_sample(*args), fused_ne.fused_level_sample_plain(*args)
    ne_k, ne_p = fused_ne.fused_level_ne(*args), fused_ne.fused_level_ne_plain(*args)
    torch.cuda.synchronize()
    assert (fused_ne.SAMPLE_LAUNCHES, fused_ne.NE_LAUNCHES) == (before[0] + 1, before[1] + 1)
    if P > 1:
        assert 0.3 < sample_k[1].float().mean().item() < 1.0
    for a, b in zip(sample_k + ne_k, sample_p + ne_p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.fixture(scope="module")
def ne_cluster_of_8(device):
    """The NE kernel built with a cluster of 8 CTAs for every frame size, as
    chip_smoke.py's sweep builds it."""
    from vslam_tpu_torch import _build

    (lib,) = _build.Variants([("fused_ne", {"kNeCtas": 8, "kNeClusterPoints": 0})]).load()
    return lib


@pytest.mark.parametrize("P", [1, 13, 100])
def test_ne_cluster_with_empty_shares_equals_plain(device, ne_cluster_of_8, P):
    """With 8 CTAs for frames of 1, 13 and 100 points (shares of 16), most
    CTAs of a cluster hold no point: bit for bit against the plain version
    summing over 8 blocks."""
    data, rel, img, cam = _random_level(device, 3, 2, P, seed=P)
    args = (data, rel, img, cam, "bilinear")
    got = fused_ne._launch_ne(*args, lib=ne_cluster_of_8)
    want = fused_ne.fused_level_ne_plain(*args, ctas=8)
    torch.cuda.synchronize()
    assert bool((got[3] > 0).any())  # some frame has a visible point
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_fused_ne_warp_sum_is_the_plain_order_bit_for_bit(device):
    """J and templates drawn over 12 orders of magnitude with both signs, on
    a zero image with every point in view, so any change in the order of the
    NE kernel's sums (the reduce-scatter within a warp, the warps, the CTAs
    of a cluster) changes their bits: the kernel equals
    `fused_solve._block_sum(ctas=fused_ne.ne_ctas(P))` bit for bit, and the
    sums in another CTA count's order differ."""
    B, F, P = 4, 2, 1920
    rng = np.random.default_rng(12)

    def spread(*shape):
        x = rng.choice([-1.0, 1.0], shape) * 10.0 ** rng.uniform(-6.0, 6.0, shape)
        return torch.as_tensor(x.astype(np.float32), device=device)

    data, rel, _, cam = _random_level(device, B, F, P, seed=12)
    pcl = data.pcl * torch.tensor([0.6, 0.6, 1.0], device=device)  # |x / z|, |y / z| < 0.48
    data = data._replace(pcl=pcl, J=spread(B, F, P, 6), templ=spread(B, F, P), mask=torch.ones_like(data.mask))
    rel = SE3(torch.eye(3, device=device).expand(B, F, 3, 3).contiguous(), torch.zeros(B, F, 3, device=device))
    img = torch.zeros(B, 120, 160, device=device)
    got = fused_ne.fused_level_ne(data, rel, img, cam, "nearest")
    want = fused_ne.fused_level_ne_plain(data, rel, img, cam, "nearest")
    other = fused_ne.fused_level_ne_plain(data, rel, img, cam, "nearest", ctas=2 if fused_ne.ne_ctas(P) == 1 else 1)
    torch.cuda.synchronize()
    assert bool((got[3] == P).all())  # every point visible
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not all(torch.equal(a, b) for a, b in zip(got[:3], other[:3]))


def test_mxu_kernel_equals_plain_bit_for_bit(device):
    rng = np.random.default_rng(5)
    B, M = 3, 5000
    img = torch.as_tensor(rng.uniform(0, 255, (B, H, W)).astype(np.float32), device=device)
    u = torch.as_tensor(rng.uniform(-3, W + 2, (B, M)).astype(np.float32), device=device)
    v = torch.as_tensor(rng.uniform(-3, H + 2, (B, M)).astype(np.float32), device=device)
    u[:, :8] = torch.tensor([-1.0, -0.5, 0.0, W - 1.0, W - 0.5, W, -1e6, 1e6], device=device)
    before = pallas_kernels.MXU_LAUNCHES
    got = pallas_kernels.bilinear_sample_mxu(img, u, v)
    want = pallas_kernels.bilinear_sample_mxu_plain(img, u, v)
    torch.cuda.synchronize()
    assert pallas_kernels.MXU_LAUNCHES == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert bool((got == 0).any()) and bool((got != 0).any())


@pytest.mark.parametrize("M,offset", [(5001, 0), (4097, 1), (3, 0)],
                         ids=["ragged", "unaligned", "fewer-than-one-thread"])
def test_mxu_kernel_with_ragged_and_unaligned_points(device, M, offset):
    """M not a multiple of a block's points, and coordinates that start off
    a 16-byte boundary: bit for bit."""
    rng = np.random.default_rng(M)
    B = 3
    img = torch.as_tensor(rng.uniform(0, 255, (B, H, W)).astype(np.float32), device=device)
    flat = torch.as_tensor(rng.uniform(-3, W + 2, B * M + offset).astype(np.float32), device=device)
    u = flat[offset:].view(B, M)
    v = torch.as_tensor(rng.uniform(-3, H + 2, (B, M)).astype(np.float32), device=device)
    got = pallas_kernels.bilinear_sample_mxu(img, u, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, pallas_kernels.bilinear_sample_mxu_plain(img, u, v), rtol=0, atol=0)


@pytest.mark.parametrize(
    "B,M,h,w,image_offset",
    [(64, 1920, 480, 640, 0), (64, 480, 240, 320, 0), (64, 120, 120, 160, 0),  # align_pairs' levels
     (70_000, 4, 6, 8, 0),  # more pairs than the grid's y extent
     (5, 1, 60, 80, 0), (5, 33, 60, 80, 0),
     (3, 100, 31, 33, 1), (3, 100, 31, 33, 2)],  # rows and images off a 16-byte boundary
    ids=["level0-480x640", "level1-240x320", "level2-120x160", "70000-pairs", "M1", "M33",
         "image-4-bytes-off", "image-8-bytes-off"])
def test_mxu_kernel_launch_shapes(device, B, M, h, w, image_offset):
    """The launch shapes of the 2-D grid: the three `align_pairs` mxu
    levels (B = 64), more pairs than the y extent of 65,535 (a block then
    also takes the pairs 65,535 apart), one and 33 points a pair, and
    images whose rows and bases are off a 16-byte boundary (the taps'
    addresses 4-byte aligned alone): bit for bit, one launch each."""
    rng = np.random.default_rng(B + M + image_offset)
    pixels = rng.uniform(0, 255, B * h * w + image_offset).astype(np.float32)
    img = torch.as_tensor(pixels, device=device)[image_offset:].view(B, h, w)
    u = torch.as_tensor(rng.uniform(-3, w + 2, (B, M)).astype(np.float32), device=device)
    v = torch.as_tensor(rng.uniform(-3, h + 2, (B, M)).astype(np.float32), device=device)
    before = pallas_kernels.MXU_LAUNCHES
    got = pallas_kernels.bilinear_sample_mxu(img, u, v)
    want = pallas_kernels.bilinear_sample_mxu_plain(img, u, v)
    torch.cuda.synchronize()
    assert pallas_kernels.MXU_LAUNCHES == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert bool((got[-1] != 0).any())  # the last pairs are sampled too


def test_mxu_kernel_at_special_coordinates(device):
    """NaN, +-inf and coordinates exactly on and just past the border (-1,
    W-1 and W; -1, H-1 and H) with every other such value: bit for bit,
    NaN where the plain version gives NaN."""
    nan, inf = float("nan"), float("inf")
    us = [nan, inf, -inf, -1.0, -0.5, 0.0, 0.5, W - 1.5, W - 1.0, W - 0.5, W]
    vs = [nan, inf, -inf, -1.0, -0.5, 0.0, 0.5, H - 1.5, H - 1.0, H - 0.5, H]
    rng = np.random.default_rng(7)
    B = 2
    img = torch.as_tensor(rng.uniform(1, 255, (B, H, W)).astype(np.float32), device=device)
    grid_u, grid_v = np.meshgrid(np.array(us, np.float32), np.array(vs, np.float32))
    u = torch.as_tensor(grid_u.ravel(), device=device).expand(B, -1).contiguous()
    v = torch.as_tensor(grid_v.ravel(), device=device).expand(B, -1).contiguous()
    got = pallas_kernels.bilinear_sample_mxu(img, u, v)
    want = pallas_kernels.bilinear_sample_mxu_plain(img, u, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert bool(torch.isnan(got).any()) and bool((got == 0).any()) and bool((got > 0).any())


def test_align_pairs_per_iteration_samplers_launch_every_iteration(device):
    from vslam_tpu_torch.parallel.batched import align_pairs

    K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    cam = Camera.create(FX, FX, (W - 1) / 2, (H - 1) / 2, device=device)
    xi = np.array([0.01, -0.01, 0.005, 0.004, -0.003, 0.002])
    frames = []
    for pose in (np.eye(4), lie_np.exp(xi)):
        inten, depth = synthetic.render(K, pose, (H, W))
        frames.append(create_frame(torch.as_tensor(inten, device=device)[None],
                                   torch.as_tensor(depth, device=device)[None], cam, n_levels=3))
    rel0 = SE3(torch.eye(3, device=device)[None], torch.zeros(1, 3, device=device))
    for sampler, counter in (("fused", lambda: fused_ne.NE_LAUNCHES),
                             ("mxu", lambda: pallas_kernels.MXU_LAUNCHES)):
        cfg = ic.AlignmentConfig(min_gradient=10.0, sampler=sampler, max_points=2048,
                                 include_prior=False, interpolation="bilinear",
                                 solver=SolverConfig(30, 1e-11, min_relative_reduction=1e-4))
        before = (counter(), fused_solve.LAUNCHES)
        rel, cov, valid = align_pairs(frames[0], frames[1], rel0, None, cfg)
        torch.cuda.synchronize()
        assert counter() - before[0] >= 3 and fused_solve.LAUNCHES == before[1]
        T = np.eye(4)
        T[:3, :3] = rel.R[0].double().cpu().numpy()
        T[:3, 3] = rel.t[0].double().cpu().numpy()
        assert bool(valid[0]) and np.linalg.norm(lie_np.log(T) - xi) < 0.01


def _pipeline_stream(n, seed=5):
    """n frames of a smooth trajectory on the plane scene at H x W, in the
    sensor dtypes (uint8 intensity, uint16 depth at 1/5000 m)."""
    K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    poses = synthetic.smooth_trajectory(n, trans_amp=0.08, rot_amp=0.03, seed=seed)
    p0i = lie_np.inv(poses[0])
    poses = [p @ p0i for p in poses]
    items = []
    for i, p in enumerate(poses):
        inten, depth = synthetic.render(K, p, (H, W))
        items.append((i * int(1e9 / 30), np.clip(np.round(inten), 0, 255).astype(np.uint8),
                      np.clip(np.round(depth * 5000.0), 0, 65535).astype(np.uint16)))
    return poses, items


def _pose_gap(a, b):
    return float(np.linalg.norm(lie_np.log(lie_np.relative(a, b))))


@pytest.mark.parametrize("sampler,loss", [("gather", "None"), ("fused_gn", "None"), ("fused_gn", "Huber")])
def test_align_build_on_the_card_equals_the_plain_versions_on_the_cpu(device, sampler, loss):
    """RgbdAligner.align_build (frame build, precompute and the cached
    two-reference solve) on CUDA against the same call on CPU tensors, where
    every kernel wrapper takes its plain version: the tolerance of
    tests/test_torch_align.py's `align` parity (pose 1e-3, covariance
    rtol 1e-2)."""
    from vslam_tpu_torch.alignment.aligner import RgbdAligner, build_frame

    poses, items = _pipeline_stream(3)
    cfg = ic.AlignmentConfig(min_gradient=10.0, sampler=sampler, max_points=2048, loss=LossConfig(loss),
                             image_dtype="bfloat16" if sampler == "fused_gn" else "float32",
                             solver=SolverConfig(50, 1e-11, min_relative_reduction=1e-4))
    pred = lie_np.exp(lie_np.log(lie_np.relative(poses[0], poses[1]))) @ poses[1]
    out = []
    for dev in (device, torch.device("cpu")):
        cam = Camera.create(FX, FX, (W - 1) / 2, (H - 1) / 2, device=dev)
        refs = [build_frame(i, d, cam, cfg, 3, 1 / 5000)[1] for _, i, d in items[:2]]
        _, i2, d2 = items[2]
        before = fused_solve.LAUNCHES
        out.append(RgbdAligner(cfg).align_build(i2, d2, cam, 3, refs, poses[:2], pred, depth_scale=1 / 5000))
        assert fused_solve.LAUNCHES - before == (3 if sampler == "fused_gn" and dev.type == "cuda" else 0)
    (_, _, pose_k, cov_k, ok_k), (_, _, pose_p, cov_p, ok_p) = out
    assert ok_k and ok_p
    assert _pose_gap(pose_k, pose_p) < 1e-3
    assert _pose_gap(pose_k, poses[2]) < 0.02
    np.testing.assert_allclose(cov_k, cov_p, rtol=1e-2, atol=1e-6 * np.abs(cov_p).max())


def test_pipelined_run_never_waits_for_the_card_while_it_queues(device, monkeypatch):
    """The software-pipelined loop queues every frame's whole update
    (`pipeline._chain_step`) with no synchronizing CUDA call inside it: torch's
    sync debug mode raises on one, as it does on a `.item()` below. The host
    waits only when it retires a batch of frames, and the trajectory is the
    strict loop's within 2e-3."""
    from vslam_tpu_torch.config import PipelineConfig
    from vslam_tpu_torch.odometry import pipeline

    with pytest.raises(RuntimeError, match="synchroniz"):
        torch.cuda.set_sync_debug_mode("error")
        try:
            torch.ones(1, device=device).item()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    chain_step, steps = pipeline._chain_step, []

    def no_wait(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = chain_step(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        steps.append(out)
        return out

    monkeypatch.setattr(pipeline, "_chain_step", no_wait)
    _, items = _pipeline_stream(10)
    cfg = PipelineConfig(features_min_gradient=10.0, solver_max_iterations=50, solver_min_step_size=1e-7,
                         sampler="fused_gn", image_dtype="bfloat16", features_max_points=2048)
    cam = Camera(FX, FX, (W - 1) / 2, (H - 1) / 2)
    before = fused_solve.LAUNCHES
    traj = pipeline.OdometryPipeline(cam, cfg).run(iter(items))
    assert len(steps) == len(items) - 1 and fused_solve.LAUNCHES - before == 3 * (len(items) - 1)
    monkeypatch.setattr(pipeline, "_chain_step", chain_step)
    strict = pipeline.OdometryPipeline(cam, cfg).run(iter(items), pipelined=False)
    for (t, a), (_, b) in zip(traj.items(), strict.items()):
        assert _pose_gap(a, b) < 2e-3, t


def _assert_solve_equal(out_k, out_p):
    (rel_k, res_k), (rel_p, res_p) = out_k, out_p
    assert res_k.iterations.tolist() == res_p.iterations.tolist()
    for a, b in [(rel_k.R, rel_p.R), (rel_k.t, rel_p.t), (res_k.A, res_p.A), (res_k.b, res_p.b),
                 (res_k.chi2, res_p.chi2), (res_k.valid, res_p.valid),
                 (res_k.chi2_history, res_p.chi2_history), (res_k.step_history, res_p.step_history)]:
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


KITTI_CAM = (718.856, 718.856, 607.1928, 185.2157)


@pytest.fixture(scope="module")
def kitti_frames(device):
    """Two frames of the KITTI bench geometry (1241x376, the street plane,
    0.3 m apart) with 4 pyramid levels: 1241x376, 621x188, 311x94 and
    156x47, an odd size at every level."""
    K = synthetic.camera_matrix(*KITTI_CAM)
    scene = synthetic.PlaneScene(normal=(0.0, -0.25, 1.0), d=12.0, n_waves=12)
    cam = Camera.create(*KITTI_CAM, device=device)
    xi = np.array([0.02, -0.01, 0.3, 0.002, -0.003, 0.001])
    frames = []
    for pose in (np.eye(4), lie_np.exp(xi)):
        inten, depth = synthetic.render(K, pose, (376, 1241), scene)
        frames.append(create_frame(torch.as_tensor(np.round(inten), device=device),
                                   torch.as_tensor(depth, device=device), cam, n_levels=4))
    return frames, xi


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_kernel_at_kitti_odd_level_sizes_equals_plain(device, kitti_frames, level):
    """The whole-level kernel at each level of KITTI's 4-level pyramid (the
    stereo scan's F = 2 slice, bilinear, bf16, prior), bit for bit."""
    (ref, cur), xi = kitti_frames
    stacked = stack_frames([stack_frames([ref, ref])])  # B = 1, the scan's {keyframe, last} slice
    cur = stack_frames([cur])
    H_l, W_l = cur.intensity[level].shape[-2:]
    assert (W_l % 2, H_l % 2) == ((1, 0) if level < 3 else (0, 1))
    data = ic.precompute_level(stacked.intensity[level], stacked.dIx[level], stacked.dIy[level],
                               stacked.depth[level], ic._first_camera(stacked.cameras[level], 1), 20.0,
                               max_points=2048 >> (2 * level))
    rel = lie_np.exp(0.9 * xi)
    rel0 = SE3(torch.as_tensor(rel[:3, :3], dtype=torch.float32, device=device).expand(1, 2, 3, 3).contiguous(),
               torch.as_tensor(rel[:3, 3], dtype=torch.float32, device=device).expand(1, 2, 3).contiguous())
    x_pred = torch.as_tensor(lie_np.log(rel), dtype=torch.float32, device=device).expand(1, 2, 6).contiguous()
    cfg = ic.AlignmentConfig(min_gradient=20.0, solver=SolverConfig(100, 1e-11, min_relative_reduction=1e-4),
                             include_prior=True, interpolation="bilinear", sampler="fused_gn",
                             image_dtype="bfloat16", max_points=2048)
    before = fused_solve.LAUNCHES
    out_k = fused_solve.solve_level_fused(data, rel0, cur.intensity[level], cur.cameras[level], cfg, x_pred)
    out_p = fused_solve.solve_level_fused_plain(data, rel0, cur.intensity[level], cur.cameras[level], cfg, x_pred)
    torch.cuda.synchronize()
    assert fused_solve.LAUNCHES == before + 1
    assert int(out_k[1].iterations.max()) > 0 or level == 3
    _assert_solve_equal(out_k, out_p)


def test_kernel_at_suite_batch_with_per_sequence_intrinsics_equals_plain(device):
    """B = S = 4 pairs of F = 2 frames, each sequence with its own fx and
    principal point (camera leaves (4,)), as the suite's step gives them."""
    fxs = [FX, FX * 1.25, FX * 0.8, FX * 1.1]
    refs, curs, rels = [], [], []
    rng = np.random.default_rng(3)
    for s, fx in enumerate(fxs):
        cx, cy = (W - 1) / 2 + s, (H - 1) / 2 - s
        K = synthetic.camera_matrix(fx, fx, cx, cy)
        cam = Camera.create(fx, fx, cx, cy, device=device)
        xi = np.concatenate([rng.uniform(-0.02, 0.02, 3), rng.uniform(-0.01, 0.01, 3)])
        scene = synthetic.default_scene(seed=100 + s)
        pair = []
        for f in range(2):
            inten, depth = synthetic.render(K, lie_np.exp(xi * f / 2), (H, W), scene)
            pair.append(create_frame(torch.as_tensor(np.round(inten), device=device),
                                     torch.as_tensor(depth, device=device), cam, n_levels=1))
            rels.append(lie_np.relative(lie_np.exp(xi * f / 2), lie_np.exp(0.9 * xi)))
        refs.append(stack_frames(pair))
        inten, depth = synthetic.render(K, lie_np.exp(xi), (H, W), scene)
        curs.append(create_frame(torch.as_tensor(np.round(inten), device=device),
                                 torch.as_tensor(depth, device=device), cam, n_levels=1))
    ref, cur = stack_frames(refs), stack_frames(curs)
    assert cur.cameras[0].fx.shape == (4,) and len(set(cur.cameras[0].fx.tolist())) == 4
    data = ic.precompute_level(ref.intensity[0], ref.dIx[0], ref.dIy[0], ref.depth[0],
                               ic._first_camera(ref.cameras[0], 4), 30.0, max_points=2048)
    rels = np.stack(rels).reshape(4, 2, 4, 4)
    rel0 = SE3(torch.as_tensor(rels[..., :3, :3], dtype=torch.float32, device=device),
               torch.as_tensor(rels[..., :3, 3], dtype=torch.float32, device=device))
    x_pred = torch.as_tensor(np.stack([lie_np.log(r) for r in rels.reshape(-1, 4, 4)]).reshape(4, 2, 6),
                             dtype=torch.float32, device=device)
    cfg = ic.AlignmentConfig(min_gradient=30.0, solver=SolverConfig(100, 1e-11, min_relative_reduction=1e-4),
                             include_prior=True, interpolation="bilinear", sampler="fused_gn",
                             image_dtype="bfloat16", max_points=2048)
    before = fused_solve.LAUNCHES
    out_k = fused_solve.solve_level_fused(data, rel0, cur.intensity[0], cur.cameras[0], cfg, x_pred)
    out_p = fused_solve.solve_level_fused_plain(data, rel0, cur.intensity[0], cur.cameras[0], cfg, x_pred)
    torch.cuda.synchronize()
    assert fused_solve.LAUNCHES == before + 1
    assert int(out_k[1].iterations.max()) > 1
    _assert_solve_equal(out_k, out_p)


def test_block_matcher_on_the_card_equals_the_cpu(device, kitti_frames):
    """`io.kitti.stereo_depth` on CUDA tensors (S = 2 pairs, one fx each)
    against the same call on CPU tensors: validity equal, disparity-derived
    depth within 1e-5 relative."""
    from vslam_tpu_torch.io import kitti

    K = synthetic.camera_matrix(*KITTI_CAM)
    scene = synthetic.PlaneScene(normal=(0.0, -0.25, 1.0), d=12.0, n_waves=12)
    shift = np.eye(4)
    shift[0, 3] = -0.5372
    left, right = (np.round(synthetic.render(K, T, (376, 1241), scene)[0]).astype(np.float32)
                   for T in (np.eye(4), shift))
    l2, r2 = np.stack([left, left]), np.stack([right, right])
    fx = torch.tensor([KITTI_CAM[0], 0.9 * KITTI_CAM[0]])
    got = kitti.stereo_depth(torch.as_tensor(l2, device=device), torch.as_tensor(r2, device=device),
                             fx.to(device), 0.5372, max_disparity=96).cpu()
    want = kitti.stereo_depth(torch.as_tensor(l2), torch.as_tensor(r2), fx, 0.5372, max_disparity=96)
    assert (want > 0).float().mean() > 0.3
    torch.testing.assert_close(got > 0, want > 0, rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# the mapping backend: features, BA, the pose graph and the chunk backend on
# the card against the same calls on the CPU
# ---------------------------------------------------------------------------


def _blob_images(n=3, h=120, w=160, seed=42):
    """Integer-valued images with bright square blobs (FAST corners)."""
    rng = np.random.default_rng(seed)
    imgs = np.full((n, h, w), 50.0, np.float32)
    for img in imgs:
        for _ in range(25):
            y, x = rng.integers(20, h - 20), rng.integers(20, w - 20)
            img[y - 3 : y + 4, x - 3 : x + 4] = 220.0
    return imgs


def test_features_on_the_card_equal_the_cpu(device):
    """Detection (integer images: exact), orientations within 1e-5 rad,
    steered descriptors >= 99 % equal bits (cos / sin may differ in the last
    bit and move a rounded offset), packing, the L1 matrix and `ratio_match`
    with `unique` exact."""
    from vslam_tpu_torch.features import descriptor, detector, matcher, tracking

    imgs = torch.as_tensor(_blob_images())
    depth = torch.full_like(imgs, 2.0)
    want = tracking._detect_describe(imgs, depth, cell=16)
    got = [t.cpu() for t in tracking._detect_describe(imgs.to(device), depth.to(device), cell=16)]
    for i in (0, 1, 2, 4):
        torch.testing.assert_close(got[i], want[i], rtol=0, atol=0)
    valid = want[2]
    bits_g = descriptor.unpack_bits(got[3])[valid]
    bits_w = descriptor.unpack_bits(want[3])[valid]
    assert valid.sum() >= 20 and (bits_g == bits_w).float().mean() >= 0.99
    uv = want[0][0][valid[0]]
    torch.testing.assert_close(descriptor.keypoint_orientations(imgs[0].to(device), uv.to(device)).cpu(),
                               descriptor.keypoint_orientations(imgs[0], uv), rtol=0, atol=1e-5)
    det = detector.fast_grid_detect(imgs.to(device), depth.to(device), threshold=20.0)
    for g, w in zip(det, detector.fast_grid_detect(imgs, depth, threshold=20.0)):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    d = bits_w[:40]
    dm = matcher.descriptor_l1_matrix(d, d.flip(0))
    torch.testing.assert_close(matcher.descriptor_l1_matrix(d.to(device), d.flip(0).to(device)).cpu(), dm,
                               rtol=0, atol=0)
    for g, w in zip(matcher.ratio_match(dm.to(device), max_distance=80.0, unique=True),
                    matcher.ratio_match(dm, max_distance=80.0, unique=True)):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


def _ba_problem(device, seed=42):
    """A depth-anchored 3-pose, 40-point BA problem with half-pixel noise."""
    from vslam_tpu_torch.ba.bundle_adjustment import BaProblem

    fx, cx, cy = 200.0, 160.0, 120.0
    rng = np.random.default_rng(seed)
    poses_gt = [lie_np.exp(np.array([0.2 * k, 0.05 * k, 0.0, 0.0, 0.1 * k, 0.0])) for k in range(3)]
    pts = np.stack([rng.uniform(-1.5, 1.5, 40), rng.uniform(-1.0, 1.0, 40), rng.uniform(2.5, 5.0, 40)], 1)
    obs = []
    for k, T in enumerate(poses_gt):
        pc = lie_np.transform(T, pts)
        for m in range(40):
            u, v = fx * pc[m, 0] / pc[m, 2] + cx, fx * pc[m, 1] / pc[m, 2] + cy
            if 0 < u < 2 * cx and 0 < v < 2 * cy:
                obs.append((k, m, u + rng.normal(0, 0.5), v + rng.normal(0, 0.5), pc[m, 2]))
    obs = np.asarray(obs)
    init = [poses_gt[0]] + [lie_np.exp(rng.normal(0, 0.03, 6)) @ T for T in poses_gt[1:]]
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)  # noqa: E731
    return BaProblem(poses=SE3(f32([T[:3, :3] for T in init]), f32([T[:3, 3] for T in init])),
                     pose_mask=torch.ones(3, dtype=torch.bool, device=device),
                     points=f32(pts + rng.normal(0, 0.05, pts.shape)),
                     point_mask=torch.ones(40, dtype=torch.bool, device=device),
                     obs_frame=torch.as_tensor(obs[:, 0].astype(np.int64), device=device),
                     obs_point=torch.as_tensor(obs[:, 1].astype(np.int64), device=device),
                     obs_uv=f32(obs[:, 2:4]), obs_mask=torch.ones(len(obs), dtype=torch.bool, device=device),
                     fx=f32(fx), fy=f32(fx), cx=f32(cx), cy=f32(cy), obs_z=f32(obs[:, 4]))


def test_bundle_adjustment_on_the_card_equals_the_cpu(device):
    """`solve_ba`: poses within 1e-4 (SE(3) log), points within 1e-3 m,
    chi2 within rtol 1e-4; the newest pose's covariance within rtol 1e-3 of
    its largest entry (f32 solves, other summation orders)."""
    from vslam_tpu_torch.ba import bundle_adjustment as ba

    got = ba.solve_ba(_ba_problem(device), max_iterations=40)
    want = ba.solve_ba(_ba_problem("cpu"), max_iterations=40)
    for k in range(3):
        Tg = np.eye(4)
        Tg[:3, :3], Tg[:3, 3] = got[0].R[k].cpu().numpy(), got[0].t[k].cpu().numpy()
        Tw = np.eye(4)
        Tw[:3, :3], Tw[:3, 3] = want[0].R[k].numpy(), want[0].t[k].numpy()
        assert np.linalg.norm(lie_np.log(lie_np.relative(Tg, Tw))) < 1e-4
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=1e-3)
    torch.testing.assert_close(got[3].cpu(), want[3], rtol=1e-4, atol=0)
    cov_g = ba.pose_covariance(_ba_problem(device), got[0], got[1], 2).cpu()
    cov_w = ba.pose_covariance(_ba_problem("cpu"), want[0], want[1], 2)
    torch.testing.assert_close(cov_g, cov_w, rtol=0, atol=1e-3 * float(cov_w.abs().max()))


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_pose_graph_on_the_card_equals_the_cpu(device, solver):
    """A 48-node chain with five loop edges: chi2 before within rtol 1e-5,
    after within rtol 1e-2, translations within 1e-4 (dense) / 5e-4 (PCG)."""
    from vslam_tpu_torch.ba import pose_graph as pg

    rng = np.random.default_rng(7)
    K = 48
    gt = [np.eye(4)]
    for _ in range(1, K):
        gt.append(lie_np.exp(np.array([0.4, 0.0, 0.05, 0.0, 2 * np.pi / K, 0.0])) @ gt[-1])
    edges = [(k, k + 1, lie_np.exp(rng.normal(0, 0.01, 6)) @ lie_np.relative(gt[k], gt[k + 1]), 1.0)
             for k in range(K - 1)]
    edges += [(a, b, lie_np.relative(gt[a], gt[b]), 100.0) for a, b in [(K - 1, 0), (K // 2, 0), (36, 12)]]
    init = [np.eye(4)]
    for k in range(K - 1):
        init.append(edges[k][2] @ init[-1])

    def graph(dev):
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)  # noqa: E731
        i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)  # noqa: E731
        return pg.PoseGraph(SE3(f32([T[:3, :3] for T in init]), f32([T[:3, 3] for T in init])),
                            i64([e[0] for e in edges]), i64([e[1] for e in edges]),
                            SE3(f32([e[2][:3, :3] for e in edges]), f32([e[2][:3, 3] for e in edges])),
                            f32([np.eye(6) * e[3] for e in edges]), torch.ones(len(edges), dtype=torch.bool,
                                                                               device=dev))

    kw = dict(solver=solver, cg_rtol=1e-8)
    og, c0g, c1g = pg.optimize_pose_graph(graph(device), **kw)
    ow, c0w, c1w = pg.optimize_pose_graph(graph("cpu"), **kw)
    torch.testing.assert_close(c0g.cpu(), c0w, rtol=1e-5, atol=0)
    torch.testing.assert_close(c1g.cpu(), c1w, rtol=1e-2, atol=1e-6)
    torch.testing.assert_close(og.t.cpu(), ow.t, rtol=0, atol=1e-4 if solver == "dense" else 5e-4)


class _CudaOps:
    """Counts, per thread name, the ATen ops that touch a CUDA tensor and
    are not views (a view launches nothing), inside `within()`."""

    def __init__(self):
        import collections

        self.by_thread = collections.Counter()

    def within(self, fn):
        import threading

        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if not func.is_view and any(torch.is_tensor(t) and t.is_cuda
                                            for t in tree_leaves((args, kwargs, out))):
                    counter.by_thread[threading.current_thread().name.split("_")[0]] += 1
                return out

        def wrapped(*a, **kw):
            with Mode():
                return fn(*a, **kw)

        return wrapped


@pytest.mark.parametrize("compute_device", ["auto", "default"])
def test_async_worker_launches_nothing_on_the_card_under_auto(device, compute_device):
    """SequentialOdometry on the card with an async backend: under "auto"
    the worker thread launches no CUDA op (it waits on the detection's
    event only), and two runs repeat to 1e-9; under "default" it does
    launch (the counter sees the card)."""
    from vslam_tpu_torch.odometry.sequential import SequentialConfig, SequentialOdometry
    from vslam_tpu_torch.odometry.sequential_mapping import ChunkMappingBackend

    h, w, fx = 96, 128, 110.0
    K = synthetic.camera_matrix(fx, fx, (w - 1) / 2, (h - 1) / 2)
    poses = synthetic.smooth_trajectory(13, trans_amp=0.06, rot_amp=0.02)
    items = []
    for i, p in enumerate(poses):
        inten, depth = synthetic.render(K, p @ lie_np.inv(poses[0]), (h, w))
        items.append((i * 33_333_333, np.round(inten).astype(np.uint8),
                      np.round(depth * 5000).astype(np.uint16)))
    cfg = SequentialConfig(alignment=ic.AlignmentConfig(min_gradient=10.0, include_prior=True),
                           depth_scale=1 / 5000, kf_period=3)
    cam = Camera.create(fx, fx, (w - 1) / 2, (h - 1) / 2, device=device)
    runs = []
    for _ in range(2 if compute_device == "auto" else 1):
        backend = ChunkMappingBackend(enable_ba=True, compute_device=compute_device, device=device)
        ops = _CudaOps()
        backend.process_chunk = ops.within(backend.process_chunk)
        runs.append(SequentialOdometry(cam, cfg, chunk=4, mapping=backend).run(iter(items)))
        assert backend.batched_detect_chunks == backend.batched_track_chunks == 3
        assert backend.n_landmarks > 0
        worker = ops.by_thread["mapping-backend"]
        assert (worker == 0) if compute_device == "auto" else (worker > 0), ops.by_thread
        assert ops.by_thread["MainThread"] > 0  # the first frame's backend call, on the card
    for (_, Ta, _), (_, Tb, _) in zip(runs[0], runs[-1]):
        np.testing.assert_allclose(Ta, Tb, atol=1e-9)


def _small_stream(n, h=96, w=128, fx=110.0):
    K = synthetic.camera_matrix(fx, fx, (w - 1) / 2, (h - 1) / 2)
    poses = synthetic.smooth_trajectory(n, trans_amp=0.06, rot_amp=0.02)
    items = []
    for i, p in enumerate(poses):
        inten, depth = synthetic.render(K, p @ lie_np.inv(poses[0]), (h, w))
        items.append((i * 33_333_333, np.round(inten).astype(np.uint8), np.round(depth * 5000).astype(np.uint16)))
    return items


def _bf16_cfg():
    from vslam_tpu_torch.odometry.sequential import SequentialConfig

    return SequentialConfig(alignment=ic.AlignmentConfig(min_gradient=10.0, include_prior=True, sampler="fused_gn",
                                                         image_dtype="bfloat16", max_points=2048),
                            depth_scale=1 / 5000, kf_period=3)


def test_checkpoint_round_trips_a_bf16_state_onto_the_card(device, tmp_path):
    """A state on the card with bf16 leaves is saved (one wait for all its
    copies) and loaded onto the card against a fresh state: every leaf on
    the card, with its dtype, bit for bit."""
    from vslam_tpu_torch.odometry.sequential import init_state
    from vslam_tpu_torch.utils import checkpoint
    from vslam_tpu_torch.utils.tree import tree_leaves, tree_map

    (_, i0, d0), = _small_stream(1)
    cam = Camera.create(110.0, 110.0, 63.5, 47.5, device=device)

    def state():
        st = init_state(i0, d0, cam, _bf16_cfg())
        return st._replace(kf_data=tree_map(lambda x: x.to(torch.bfloat16) if x.is_floating_point() else x,
                                            st.kf_data))

    saved = state()
    saved = saved._replace(speed=saved.speed + 0.25)
    path = str(tmp_path / "state.npz")
    checkpoint.save_sequential(path, saved, 99)
    back, t_last = checkpoint.load_sequential(path, state())
    assert t_last == 99
    got, want = tree_leaves(back), tree_leaves(saved)
    assert any(x.dtype == torch.bfloat16 for x in got)
    for a, b in zip(got, want):
        assert a.is_cuda and a.dtype == b.dtype and a.shape == b.shape
        bits = (lambda x: x.view(torch.int16)) if a.dtype == torch.bfloat16 else (lambda x: x)
        assert torch.equal(bits(a), bits(b))


def test_resumed_scan_on_the_card_equals_the_uninterrupted(device, tmp_path):
    """8 frames, a checkpoint, a fresh SequentialOdometry and state, 4 more: the poses
    equal the uninterrupted run's bit for bit (the step does not depend on
    where a chunk starts)."""
    from vslam_tpu_torch.odometry.sequential import SequentialOdometry, init_state
    from vslam_tpu_torch.utils import checkpoint

    items = _small_stream(12)
    cam = Camera.create(110.0, 110.0, 63.5, 47.5, device=device)
    full = SequentialOdometry(cam, _bf16_cfg(), chunk=4).run(iter(items))
    odo = SequentialOdometry(cam, _bf16_cfg(), chunk=4)
    first = odo.run(iter(items[:8]))
    path = str(tmp_path / "state.npz")
    checkpoint.save_sequential(path, odo.state, odo._t_last_ns)
    odo2 = SequentialOdometry(cam, _bf16_cfg(), chunk=4)
    odo2.state, odo2._t_last_ns = checkpoint.load_sequential(path, init_state(*items[0][1:], cam, _bf16_cfg()))
    resumed = first + odo2.run(iter(items[8:]))
    assert [t for t, _, _ in resumed] == [t for t, _, _ in full]
    for (_, Ta, _), (_, Tb, _) in zip(resumed, full):
        np.testing.assert_array_equal(Ta, Tb)


def test_viewer_adds_no_wait_for_the_card(device):
    """SequentialOdometry with a viewer waits for the card as often as
    without one (torch's sync debug mode counts the waits), and launches
    as many whole-level solves: it publishes from the chunk's one fetch."""
    import warnings

    from vslam_tpu_torch.odometry.sequential import SequentialOdometry
    from vslam_tpu_torch.viz import LiveViz

    items = _small_stream(9)
    cam = Camera.create(110.0, 110.0, 63.5, 47.5, device=device)
    SequentialOdometry(cam, _bf16_cfg(), chunk=4).run(iter(items))  # the first run's one-time waits
    counts = []
    for with_viz in (False, True):
        viz = LiveViz(port=0) if with_viz else None
        try:
            odo = SequentialOdometry(cam, _bf16_cfg(), chunk=4, viz=viz)
            before = fused_solve.LAUNCHES
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    odo.run(iter(items))
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            counts.append((sum("synchronizing" in str(w.message) for w in caught), fused_solve.LAUNCHES - before))
            if viz is not None:
                assert viz.state()["n_frames"] == 9
        finally:
            if viz is not None:
                viz.close()
    assert counts[0] == counts[1], counts


def test_device_memory_stats_on_the_card(device):
    from vslam_tpu_torch.utils.profiling import device_memory_stats

    x = torch.ones(1 << 20, device=device)
    stats = device_memory_stats()
    assert stats == device_memory_stats(device)
    assert {"bytes_in_use", "peak_bytes_in_use", "bytes_limit", "bytes_reserved", "num_allocs"} <= set(stats)
    assert all(isinstance(v, int) for v in stats.values())
    assert stats["peak_bytes_in_use"] >= stats["bytes_in_use"] >= x.numel() * 4 > 0
    assert stats["bytes_limit"] >= stats["bytes_reserved"] >= stats["bytes_in_use"]


# ---------------------------------------------------------------------------
# Frame build (csrc/frame_build.cu) against the plain stencils on the CPU
# ---------------------------------------------------------------------------


def _sensor_batch(rng, shape, holes=0.3):
    """uint8 intensity and int16 bits of unsigned depth counts, counts of
    32768 and more among them, a share of holes (count 0)."""
    inten = rng.integers(0, 256, shape, dtype=np.uint8)
    counts = rng.integers(1, 65536, shape).astype(np.uint16)
    counts[rng.uniform(size=shape) < holes] = 0
    return inten, counts.view(np.int16)


def _assert_pyramids_equal(kernel, plain, frames=None):
    """Every plane of every level bit for bit; ``frames`` the leading-axis
    indices of the kernel's planes that ``plain`` holds."""
    for name, k_levels, p_levels in zip(("intensity", "depth", "dIx", "dIy"), kernel, plain):
        assert len(k_levels) == len(p_levels)
        for lvl, (k, p) in enumerate(zip(k_levels, p_levels)):
            k = (k if frames is None else k[frames]).cpu().contiguous()
            p = p.contiguous()
            assert k.shape == p.shape and k.dtype == p.dtype == torch.float32, (name, lvl, k.shape, p.shape)
            if not torch.equal(k.view(torch.int32), p.view(torch.int32)):
                bad = (k.view(torch.int32) != p.view(torch.int32)).nonzero()[:5].tolist()
                raise AssertionError(f"{name} level {lvl}: max_abs_err {(k - p).abs().max().item()}, "
                                     f"first differing indices {bad}")


def _kernel_vs_cpu(device, inten, depth, n_levels, depth_scale=1.0, frames=None):
    """The kernel on the card and the plain version on the same tensors on
    the CPU (``frames``: only those leading indices on the CPU)."""
    from vslam_tpu_torch.core import frame_build

    ti, td = torch.as_tensor(inten), torch.as_tensor(depth)
    before = frame_build.FRAME_BUILD_LAUNCHES
    out = frame_build.build_pyramid(ti.to(device), td.to(device), n_levels, depth_scale)
    torch.cuda.synchronize()
    assert frame_build.FRAME_BUILD_LAUNCHES == before + n_levels
    sub = (lambda t: t) if frames is None else (lambda t: t[frames])
    plain = frame_build.build_pyramid_plain(sub(ti), sub(td), n_levels, depth_scale)
    _assert_pyramids_equal(out, plain, frames)
    return out


@pytest.mark.parametrize("S", [1, 3, 512])
def test_frame_build_kernel_equals_plain_at_tum_shapes(device, S):
    """The suite's frames: S x 480 x 640 uint8 + 16-bit counts at 1/5000 m,
    3 levels. At S = 512 the CPU holds 16 of the frames, the first and the
    last among them, and the plain version on the card all of them."""
    from vslam_tpu_torch.core import frame_build

    rng = np.random.default_rng(S)
    inten, depth = _sensor_batch(rng, (S, 480, 640))
    frames = None if S < 512 else torch.as_tensor([0, 1, 2, 3, 64, 65535 // 256, 300, 301] + list(range(504, 512)))
    out = _kernel_vs_cpu(device, inten, depth, 3, 1.0 / 5000.0, frames)
    if frames is not None:
        plain = frame_build.build_pyramid_plain(torch.as_tensor(inten, device=device),
                                                torch.as_tensor(depth, device=device), 3, 1.0 / 5000.0)
        _assert_pyramids_equal(out, tuple([t.cpu() for t in lv] for lv in plain))


def test_frame_build_kernel_equals_plain_on_the_pair_runners_f32_images(device):
    """f32 intensity and f32 metres, as the pair cell's set-up and the
    aligners pass them (depth widened and scaled before the build)."""
    rng = np.random.default_rng(11)
    inten, bits = _sensor_batch(rng, (4, 480, 640))
    depth = (bits.view(np.uint16).astype(np.float32) * np.float32(1.0 / 5000.0))
    _kernel_vs_cpu(device, inten.astype(np.float32), depth, 3)


@pytest.mark.parametrize("inten_dtype", [np.float32, np.uint8])
def test_frame_build_kernel_equals_plain_at_kitti_stereo_shapes(device, inten_dtype):
    """KITTI's 1241x376 at 4 levels (621x188, 311x94, 156x47: odd at every
    level, no width a multiple of 4 but the last) with f32 depth, as
    `stereo_depth` gives it."""
    rng = np.random.default_rng(12)
    inten, _ = _sensor_batch(rng, (2, 376, 1241))
    depth = rng.uniform(2.0, 80.0, (2, 376, 1241)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.2] = 0.0
    _kernel_vs_cpu(device, inten.astype(inten_dtype), depth, 4)


@pytest.mark.parametrize("shape,n_levels", [((5, 7), 3), ((9, 3), 2), ((3, 3), 2), ((3, 5), 1), ((2, 17, 130), 3),
                                            ((1, 33, 67), 3), ((2, 40, 48), 3), ((1, 31, 256), 4)],
                         ids=str)
def test_frame_build_kernel_equals_plain_at_small_and_odd_shapes(device, shape, n_levels):
    """Sizes below one tile, partial tiles, widths that take the scalar
    paths (not a multiple of 4 or 16) and the vector ones."""
    rng = np.random.default_rng(sum(shape))
    inten, depth = _sensor_batch(rng, shape)
    _kernel_vs_cpu(device, inten, depth, n_levels, 1.0 / 5000.0)
    _kernel_vs_cpu(device, inten.astype(np.float32), depth.view(np.uint16).astype(np.float32) / 7.0, n_levels)


def test_frame_build_kernel_equals_plain_on_special_depth(device):
    """f32 depth with NaN, +-inf, 0 and negative values, and holes laid out
    so that every valid count 0..9 of the level-1 median occurs; a depth
    scale that overflows large values to inf."""
    rng = np.random.default_rng(13)
    shape = (3, 64, 96)
    inten, _ = _sensor_batch(rng, shape)
    depth = rng.uniform(0.5, 4.0, shape).astype(np.float32)
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -1.0, -0.0, 3.0e38, 1e-40], np.float32)
    depth[rng.uniform(size=shape) < 0.3] = 0.0
    pick = rng.uniform(size=shape) < 0.1
    depth[pick] = rng.choice(special, int(pick.sum()))
    # 3x3 windows with exactly k valid pixels at the even centres of a band
    for k in range(10):
        y, x = 2 + 4 * (k // 5), 4 + 8 * (k % 5)
        win = np.zeros(9, np.float32)
        win[:k] = rng.uniform(0.5, 4.0, k)
        depth[0, y - 1:y + 2, x - 1:x + 2] = rng.permutation(win).reshape(3, 3)
    out = _kernel_vs_cpu(device, inten, depth, 3)
    counts = {k: 0 for k in range(10)}
    d0 = torch.as_tensor(depth[0])
    valid = torch.isfinite(d0) & (d0 > 0)
    for y in range(2, 63, 2):
        for x in range(2, 95, 2):
            counts[int(valid[y - 1:y + 2, x - 1:x + 2].sum())] += 1
    assert all(counts[k] > 0 for k in range(10)), counts
    _kernel_vs_cpu(device, inten, depth, 3, depth_scale=4.0)
    assert torch.isfinite(out[1][0]).all()


def test_frame_build_kernel_equals_plain_with_two_batch_axes_and_unaligned_images(device):
    """(2, 3, H, W) images; and images starting one frame into their
    storage, at an address no vector load may take."""
    rng = np.random.default_rng(14)
    inten, depth = _sensor_batch(rng, (2, 3, 45, 64))
    out = _kernel_vs_cpu(device, inten, depth, 3, 1.0 / 5000.0)
    assert out[0][2].shape == (2, 3, 12, 16)
    from vslam_tpu_torch.core import frame_build

    inten, depth = _sensor_batch(rng, (4, 45, 65))
    ti, td = torch.as_tensor(inten, device=device)[1:], torch.as_tensor(depth, device=device)[1:]
    assert ti.data_ptr() % 16 and td.data_ptr() % 16 and ti.is_contiguous()
    got = frame_build.build_pyramid(ti, td, 3, 1.0 / 5000.0)
    _assert_pyramids_equal(got, frame_build.build_pyramid_plain(ti.cpu(), td.cpu(), 3, 1.0 / 5000.0))


def test_scan_frame_build_runs_the_kernel_and_counts_its_frames(device):
    """`_sensor_frame` on the card: one launch a level, the frames counted
    under "frame.kernel_frames" inside the span "frame.build", and the same
    frame as the plain build on the CPU."""
    from vslam_tpu_torch.core import frame_build
    from vslam_tpu_torch.odometry import sequential
    from vslam_tpu_torch.utils import timer

    rng = np.random.default_rng(15)
    inten, depth = _sensor_batch(rng, (5, 48, 64))
    cfg = sequential.SequentialConfig(depth_scale=1.0 / 5000.0)
    cam = Camera.create(50.0, 50.0, 31.5, 23.5, device=device)
    timer.reset()
    before = frame_build.FRAME_BUILD_LAUNCHES
    with timer.scope("scan.step"):
        cur = sequential._sensor_frame(torch.as_tensor(inten, device=device), torch.as_tensor(depth, device=device),
                                       cam, cfg)
    assert frame_build.FRAME_BUILD_LAUNCHES == before + 3
    assert timer.counter("frame.kernel_frames") == 5
    assert timer.stats("frame.build", within="scan.step")["count"] == 1
    cpu = sequential._sensor_frame(torch.as_tensor(inten), torch.as_tensor(depth),
                                   Camera.create(50.0, 50.0, 31.5, 23.5, device="cpu"), cfg)
    _assert_pyramids_equal((cur.intensity, cur.depth, cur.dIx, cur.dIy), (cpu.intensity, cpu.depth, cpu.dIx, cpu.dIy))
    timer.reset()


def test_suite_pass_builds_every_frame_through_the_kernel(device):
    """A suite pass as the suite cell runs it (`MultiSequenceOdometry.
    run_staged`): every frame, the first frames included, built by the
    kernel and counted under "frame.kernel_frames", one launch a level a
    build."""
    from vslam_tpu_torch.core import frame_build
    from vslam_tpu_torch.odometry.sequential import SequentialConfig
    from vslam_tpu_torch.parallel.sequences import MultiSequenceOdometry
    from vslam_tpu_torch.utils import timer

    S, F = 3, 7
    rng = np.random.default_rng(16)
    streams = [[(i * 33_333_333, rng.integers(0, 256, (48, 64), dtype=np.uint8),
                 rng.integers(0, 65536, (48, 64)).astype(np.uint16)) for i in range(F)] for _ in range(S)]
    odo = MultiSequenceOdometry([Camera.create(50.0, 50.0, 31.5, 23.5, device=device)] * S,
                                SequentialConfig(depth_scale=1.0 / 5000.0), chunk=4)
    firsts, chunks = odo.stage_streams([iter(s) for s in streams])
    timer.reset()
    before = frame_build.FRAME_BUILD_LAUNCHES
    out = odo.run_staged(firsts, chunks)
    assert [len(seq) for seq in out] == [F] * S
    assert timer.counter("frame.kernel_frames") == S * F
    assert frame_build.FRAME_BUILD_LAUNCHES - before == 3 * F  # the first frames' build, then F - 1 steps
    timer.reset()


def test_frame_build_wrapper_refuses_bad_inputs_on_the_card(device):
    from vslam_tpu_torch.core import frame_build

    before = frame_build.FRAME_BUILD_LAUNCHES
    x = torch.zeros(2, 8, 10, device=device)
    with pytest.raises(ValueError, match="contiguous"):
        frame_build._launch(x.transpose(-1, -2).contiguous().transpose(-1, -2), x, 2)
    with pytest.raises(ValueError, match="intensity: expected uint8 or float32"):
        frame_build.build_pyramid(x.double(), x, 2)
    with pytest.raises(ValueError, match="one shape"):
        frame_build.build_pyramid(x, x[:1], 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        frame_build._launch(x, x.cpu(), 2)
    assert frame_build.FRAME_BUILD_LAUNCHES == before
