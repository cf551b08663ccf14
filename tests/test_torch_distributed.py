"""The port's multi-device layer (`vslam_tpu_torch.parallel.batched.
{make_mesh, shard_batch, sharded_tracking_step}`, `parallel.multihost`,
`parallel.sequences.{sharded_scan_sequences, MultiSequenceOdometry(mesh=)}`
on torch.distributed) against the JAX package's sharded functions on the
8-device virtual CPU mesh, and against the port's unsharded path.

The port runs in real rank processes (`tests/torch_ranks.py`: one process
a rank, gloo over a file store, one torch thread each), on the same numpy
inputs the JAX functions get here. Sizes are the JAX tests': 96x128, 3
levels. Tolerances:
* layouts: each rank's block equals the JAX array's addressable shard at
  the same mesh coordinate, exactly;
* tracking (B = 8 over 4 ranks, 1-D and (2, 2)): `rel` within 1e-3 (SE(3)
  log) of JAX's, the filter's velocity within atol 1e-2 and P within rtol
  1e-3 / atol 1e-5 (`tests/test_torch_kalman.py`'s tolerances), `valid`
  equal, `frac` exactly JAX's; against the port's unsharded
  `tracking_step`, `rel` within 1e-5 (the JAX multihost test's atol) and
  `frac` the mean of `valid`;
* suite (S = 8 over 4 ranks, 6 frames, chunk 3; and S = 4 over 2 ranks
  with ragged lengths): every rank returns all S trajectories; each pose
  within 1e-4 of the unsharded port run
  (`tests/test_sequences.py`'s sharded tolerance) and within 1e-3 of JAX's
  sharded run (`tests/test_torch_sequences.py`'s); `sharded_scan_sequences`
  on one chunk within 1e-5 of the unsharded `scan_sequences`, `frac` exact;
* a ragged (S, K) = (2, 2) chunk at 48x64 over 2 ranks, with one rank's
  block all dead and with every rank live: `valid` equal to JAX's
  `sharded_scan_sequences` on 2 virtual devices, `frac` exactly JAX's;
* full SLAM sharded over 2 ranks (`tests/test_sequences.py::
  test_sharded_full_slam_with_loop_closure`'s gate): closures >= 1,
  anchored ATE <= 1.05 x online and < 0.05 m.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.alignment.ic import AlignmentConfig as JAlignmentConfig
from vslam_tpu.core.camera import Camera as JCamera
from vslam_tpu.core.frame import create_frame as j_create_frame
from vslam_tpu.kalman import ekf_se3 as jekf
from vslam_tpu.odometry.sequential import SequentialConfig as JSequentialConfig
from vslam_tpu.parallel import batched as jbatched
from vslam_tpu.parallel import multihost as jmultihost
from vslam_tpu.parallel import sequences as jmseq
from vslam_tpu.solvers import LossConfig as JLossConfig
from vslam_tpu.solvers import SolverConfig as JSolverConfig
from vslam_tpu_torch import interop
from vslam_tpu_torch.core import lie_np
from vslam_tpu_torch.core.camera import Camera
from vslam_tpu_torch.eval import metrics
from vslam_tpu_torch.io import synthetic
from vslam_tpu_torch.odometry.sequential import _upload
from vslam_tpu_torch.parallel import batched, multihost, sequences
from torch_ranks import GROUP_TIMEOUT_S, Ranks, spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

H, W, FX = 96, 128, 110.0
CX, CY = (W - 1) / 2, (H - 1) / 2
K = synthetic.camera_matrix(FX, FX, CX, CY)
DT_NS = int(1e9 / 30)
TO_NP = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


def _gap(a, b) -> float:
    return float(np.linalg.norm(lie_np.log(lie_np.relative(np.asarray(a), np.asarray(b)))))


def _T(R, t):
    T = np.eye(4)
    u, _, vt = np.linalg.svd(np.asarray(R, np.float64))
    T[:3, :3], T[:3, 3] = u @ vt, t
    return T


def _cpu_devices(n):
    devices = jax.devices("cpu")
    assert len(devices) >= n, "the conftest makes 8 virtual CPU devices"
    return devices[:n]


@pytest.mark.parametrize("n_seq,n_proc", [(10, 4), (8, 8), (3, 4), (7, 2)])
def test_shard_sequences_matches_jax(n_seq, n_proc):
    for p in range(n_proc):
        assert multihost.shard_sequences(n_seq, p, n_proc) == jmultihost.shard_sequences(n_seq, p, n_proc)


def test_make_mesh_without_a_group_names_initialize():
    with pytest.raises(RuntimeError, match="multihost.initialize"):
        batched.make_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="multihost.initialize"):
        multihost.shard_sequences(8)


def test_initialize_without_cluster_settings_raises(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        multihost.initialize(device="cpu")


# ---------------------------------------------------------------------------
# layouts: 8 ranks against the 8-device virtual mesh
# ---------------------------------------------------------------------------

B_LAYOUT = 16


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    tree = (np.arange(B_LAYOUT * 3, dtype=np.float32).reshape(B_LAYOUT, 3),
            np.arange(B_LAYOUT, dtype=np.int32) * 7, np.float32(2.5))
    return tree, spawn("layouts", 8, tree, tmp_path_factory.mktemp("layouts"))


def _jax_shard(arr, device):
    (shard,) = [s for s in arr.addressable_shards if s.device == device]
    return np.asarray(shard.data)


@pytest.mark.parametrize("layout", ["shard_batch", "shard_batch_2d", "host_local_to_global"])
def test_rank_blocks_match_jax_shards(layouts, layout):
    tree, results = layouts
    if layout == "shard_batch":
        jmesh = jbatched.make_mesh(_cpu_devices(8))
        jtree = jbatched.shard_batch(tree, jmesh)
    else:
        jmesh = jmultihost.dcn_ici_mesh(n_hosts=2, devices=_cpu_devices(8))
        jtree = getattr(jmultihost, layout)(tree, jmesh)
    grid = np.asarray(jmesh.devices)
    for rank, res in enumerate(results):
        coord = res["coordinate"] if layout == "shard_batch" else res["coordinate_2d"]
        assert tuple(coord) == np.unravel_index(rank, grid.shape)
        for got, want in zip(res[layout], jtree):
            np.testing.assert_array_equal(got, _jax_shard(want, grid[tuple(coord)]))


def test_layout_defaults_and_refusals(layouts):
    _, results = layouts
    for rank, res in enumerate(results):
        assert res["nodes_shape"] == (1, 8)  # one node: one row
        assert res["shard_sequences"] == (2 * rank, 2 * rank + 2)
        assert "does not split into 8" in res["not_divisible"]


# ---------------------------------------------------------------------------
# the sharded tracking step: B = 8 over 4 ranks
# ---------------------------------------------------------------------------

B_TRACK = 8


def _pairs(B, seed):
    rng = np.random.default_rng(seed)
    cam = JCamera.create(FX, FX, CX, CY)
    refs, curs = [], []
    for b in range(B):
        scene = synthetic.default_scene(seed=b)
        xi = np.concatenate([rng.uniform(-0.02, 0.02, 3), rng.uniform(-0.01, 0.01, 3)])
        for lst, pose in ((refs, np.eye(4)), (curs, lie_np.exp(xi))):
            inten, depth = synthetic.render(K, pose, (H, W), scene)
            lst.append(j_create_frame(jnp.asarray(inten), jnp.asarray(depth), cam, n_levels=3))
    stack = lambda fs: jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *fs)  # noqa: E731
    return stack(refs), stack(curs)


@pytest.fixture(scope="module")
def tracking(tmp_path_factory):
    """(JAX 1-D and 2-D results, the port's unsharded result, the ranks')."""
    ref, cur = _pairs(B_TRACK, seed=5)
    cfg = JAlignmentConfig(min_gradient=5.0, loss=JLossConfig("Huber"),
                           solver=JSolverConfig(max_iterations=5, min_step_size=1e-6), include_prior=True)
    ekf0 = jax.vmap(lambda _: jekf.init(dtype=jnp.float32))(jnp.arange(B_TRACK))
    dt = jnp.full((B_TRACK,), 1.0 / 30.0, jnp.float32)
    payload = {"ekf": TO_NP(ekf0), "ref": TO_NP(ref), "cur": TO_NP(cur), "dt": np.asarray(dt),
               "cfg": dataclasses.asdict(cfg)}
    ranks = Ranks("tracking", 4, payload, tmp_path_factory.mktemp("tracking"))
    jmesh = jbatched.make_mesh(_cpu_devices(4))
    j1 = jbatched.sharded_tracking_step(jmesh, cfg)(*jbatched.shard_batch((ekf0, ref, cur, dt), jmesh))
    jmesh2 = jmultihost.dcn_ici_mesh(n_hosts=2, devices=_cpu_devices(4))
    j2 = jmultihost.sharded_tracking_step_2d(jmesh2, cfg)(*jmultihost.shard_batch_2d((ekf0, ref, cur, dt), jmesh2))
    tcfg = interop.alignment_config_from_fields(payload["cfg"])
    plain = batched.tracking_step(interop.ekf_state_from_numpy(payload["ekf"], device="cpu"),
                                  interop.frame_from_numpy(payload["ref"], device="cpu"),
                                  interop.frame_from_numpy(payload["cur"], device="cpu"),
                                  torch.tensor(payload["dt"]), tcfg)
    return {"1d": TO_NP(j1), "2d": TO_NP(j2)}, plain, ranks.results()


@pytest.mark.parametrize("layout", ["1d", "2d"])
def test_sharded_tracking_step_matches_jax(tracking, layout):
    jax_out, plain, ranks = tracking
    # the ranks' blocks in rank order are the global batch (both layouts)
    ekf = [r[layout][0] for r in ranks]
    rel_R = np.concatenate([r[layout][1].R for r in ranks])
    rel_t = np.concatenate([r[layout][1].t for r in ranks])
    valid = np.concatenate([r[layout][2] for r in ranks])
    fracs = {float(r[layout][3]) for r in ranks}
    j_ekf, j_rel, j_valid, j_frac = jax_out[layout]
    assert [len(r[layout][2]) for r in ranks] == [B_TRACK // 4] * 4
    np.testing.assert_array_equal(valid, j_valid)
    assert valid.any()
    for b in range(B_TRACK):
        assert _gap(_T(rel_R[b], rel_t[b]), _T(j_rel.R[b], j_rel.t[b])) < 1e-3
    np.testing.assert_allclose(np.concatenate([e.velocity for e in ekf]), j_ekf.velocity, atol=1e-2)
    np.testing.assert_allclose(np.concatenate([e.P for e in ekf]), j_ekf.P, rtol=1e-3, atol=1e-5)
    assert fracs == {float(j_frac)}  # one value on every rank, exactly JAX's
    # against the port's unsharded step
    np.testing.assert_allclose(rel_t, plain[1].t.numpy(), atol=1e-5)
    np.testing.assert_allclose(rel_R, plain[1].R.numpy(), atol=1e-5)
    np.testing.assert_array_equal(valid, plain[2].numpy())
    assert fracs == {float(plain[2].float().mean())}


# ---------------------------------------------------------------------------
# the suite: S = 8 over 4 ranks
# ---------------------------------------------------------------------------

S_SUITE, SUITE_FRAMES, SUITE_CHUNK = 8, 6, 3
JSEQ_CFG = JSequentialConfig(
    alignment=JAlignmentConfig(min_gradient=10.0, solver=JSolverConfig(max_iterations=50, min_step_size=1e-7),
                               include_prior=True, prior_weight=(FX / 525.0) ** 2),
    n_levels=3, kf_period=5)


def _stream(n, seed):
    poses = synthetic.smooth_trajectory(n, trans_amp=0.08, rot_amp=0.03)
    p0i = lie_np.inv(poses[0])
    poses = [p @ p0i for p in poses]
    scene = synthetic.default_scene(seed=seed)
    items = []
    for i, p in enumerate(poses):
        inten, depth = synthetic.render(K, p, (H, W), scene)
        items.append((i * DT_NS, inten.astype(np.float32), depth.astype(np.float32)))
    return poses, items


def _ate(poses, results):
    gt = {i * DT_NS / 1e9: lie_np.inv(p) for i, p in enumerate(poses)}
    ate, n = metrics.ate_rmse(gt, {t / 1e9: lie_np.inv(p) for t, p, _ in results})
    assert n == len(results)
    return ate


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    """(ground truths, streams, JAX's sharded run, the unsharded port run and
    its first chunk's scan, the ranks' results)."""
    made = [_stream(SUITE_FRAMES, seed=s) for s in range(S_SUITE)]
    poses, streams = [m[0] for m in made], [m[1] for m in made]
    payload = {"cfg": dataclasses.asdict(JSEQ_CFG), "cameras": [(FX, FX, CX, CY)] * S_SUITE, "streams": streams,
               "chunk": SUITE_CHUNK}
    ranks = Ranks("suite", 4, payload, tmp_path_factory.mktemp("suite"))
    jmesh = jbatched.make_mesh(_cpu_devices(S_SUITE))
    jres = jmseq.MultiSequenceOdometry([JCamera.create(FX, FX, CX, CY)] * S_SUITE, JSEQ_CFG, chunk=SUITE_CHUNK,
                                       mesh=jmesh).run([iter(s) for s in streams])
    cfg = interop.sequential_config_from_fields(dataclasses.asdict(JSEQ_CFG))
    odo = sequences.MultiSequenceOdometry([Camera.create(FX, FX, CX, CY, device="cpu")] * S_SUITE, cfg,
                                          chunk=SUITE_CHUNK)
    plain = odo.run([iter(s) for s in streams])
    firsts, chunks = odo.stage_streams([iter(s) for s in streams])
    states = sequences.init_states(_upload(np.stack([f[1] for f in firsts]), "cpu"),
                                   _upload(np.stack([f[2] for f in firsts]), "cpu"), odo.cameras, cfg)
    c = chunks[0]
    scan = sequences.scan_sequences(states, c.intensity, c.depth, c.dts, c.live, odo.cameras, cfg)
    return poses, streams, jres, plain, scan, ranks.results()


@pytest.mark.parametrize("which", ["run", "run_staged"])
def test_multi_sequence_mesh_matches_unsharded_and_jax(suite, which):
    poses, _, jres, plain, _, ranks = suite
    assert [r["block"] for r in ranks] == [(2 * k, 2 * k + 2) for k in range(4)]
    for r in ranks:
        got = r[which]
        assert len(got) == S_SUITE
        for s in range(S_SUITE):
            assert [t for t, _, _ in got[s]] == [t for t, _, _ in plain[s]] == [t for t, _, _ in jres[s]]
            assert max(_gap(a, b) for (_, a, _), (_, b, _) in zip(got[s], plain[s])) < 1e-4
            assert max(_gap(a, b) for (_, a, _), (_, b, _) in zip(got[s], jres[s])) < 1e-3
            assert _ate(poses[s], got[s]) < 0.01
            # every rank holds the same gathered trajectories
            for (_, a, ca), (_, b, cb) in zip(got[s], ranks[0][which][s]):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(ca, cb)
    # one reduce a chunk: 5 frames after the first in chunks of 3, every frame valid
    assert all(r["fracs"] == [1.0, 1.0] for r in ranks)


def test_sharded_scan_sequences_matches_scan_sequences(suite):
    _, _, _, _, scan, ranks = suite
    _, poses, valid, _, _ = scan
    want_frac = float(valid.float().mean())
    for r in ranks:
        lo, hi = r["block"]
        np.testing.assert_allclose(r["scan"]["R"], poses.R[lo:hi].numpy(), atol=1e-5)
        np.testing.assert_allclose(r["scan"]["t"], poses.t[lo:hi].numpy(), atol=1e-5)
        np.testing.assert_array_equal(r["scan"]["valid"], valid[lo:hi].numpy())
        assert r["scan"]["frac"] == want_frac


# one (S, K) = (2, 2) chunk at 48x64 over 2 ranks, a sequence a rank; the
# live masks: rank 1's block all dead (JAX's frac 2 / (2 + 1), where a sum
# clamped after the reduce would give 2 / 2), and a live slot on every rank
RAGGED_H, RAGGED_W, RAGGED_FX = 48, 64, 55.0
RAGGED_LIVES = {"one_rank_all_dead": [[True, True], [False, False]],
                "every_rank_live": [[True, True], [True, False]]}
JRAGGED_CFG = JSequentialConfig(
    alignment=JAlignmentConfig(min_gradient=10.0, solver=JSolverConfig(max_iterations=50, min_step_size=1e-7),
                               include_prior=True, prior_weight=(RAGGED_FX / 525.0) ** 2),
    n_levels=2, kf_period=5)


@pytest.fixture(scope="module")
def ragged_chunk(tmp_path_factory):
    """(JAX's (valid, frac) per live mask, the ranks' results)."""
    cx, cy = (RAGGED_W - 1) / 2, (RAGGED_H - 1) / 2
    K_small = synthetic.camera_matrix(RAGGED_FX, RAGGED_FX, cx, cy)
    poses = synthetic.smooth_trajectory(3, trans_amp=0.08, rot_amp=0.03)
    p0i = lie_np.inv(poses[0])
    frames = [[synthetic.render(K_small, p @ p0i, (RAGGED_H, RAGGED_W), synthetic.default_scene(seed=s))
               for p in poses] for s in range(2)]
    arr = lambda k, sl: np.stack([np.stack([f[k] for f in seq[sl]]) for seq in frames]).astype(np.float32)  # noqa: E731
    payload = {"cfg": dataclasses.asdict(JRAGGED_CFG), "cameras": [(RAGGED_FX, RAGGED_FX, cx, cy)] * 2,
               "i0": arr(0, slice(0, 1))[:, 0], "d0": arr(1, slice(0, 1))[:, 0],
               "intensity": arr(0, slice(1, 3)), "depth": arr(1, slice(1, 3)),
               "dts": np.full((2, 2), DT_NS / 1e9, np.float32),
               "lives": [np.asarray(v) for v in RAGGED_LIVES.values()]}
    ranks = Ranks("scan_chunk", 2, payload, tmp_path_factory.mktemp("scan_chunk"))
    jmesh = jbatched.make_mesh(_cpu_devices(2))
    jcams = jmseq.stack_cameras([JCamera.create(RAGGED_FX, RAGGED_FX, cx, cy)] * 2)
    step = jmseq.sharded_scan_sequences(jmesh, JRAGGED_CFG)
    want = {}
    for name, live in zip(RAGGED_LIVES, payload["lives"]):
        states = jmseq.init_states(jnp.asarray(payload["i0"]), jnp.asarray(payload["d0"]), jcams, JRAGGED_CFG)
        out = step(states, jnp.asarray(payload["intensity"]), jnp.asarray(payload["depth"]),
                   jnp.asarray(payload["dts"]), jnp.asarray(live), jcams)
        want[name] = (np.asarray(out[2]), float(out[5]))
    return want, {name: [r[i] for r in ranks.results()] for i, name in enumerate(RAGGED_LIVES)}


@pytest.mark.parametrize("case", list(RAGGED_LIVES))
def test_sharded_scan_sequences_frac_matches_jax_on_a_ragged_chunk(ragged_chunk, case):
    """Each rank clamps its own live count before the reduce, as the JAX
    function does: ``frac`` equals JAX's exactly on every rank."""
    want, got = ragged_chunk[0][case], ragged_chunk[1][case]
    live = np.asarray(RAGGED_LIVES[case])
    valid = np.concatenate([r["valid"] for r in got])
    np.testing.assert_array_equal(valid, want[0])
    assert valid[live].all()  # every live slot tracked: frac counts live slots only
    assert {r["frac"] for r in got} == {want[1]}
    n_live = live.sum(axis=1)
    assert want[1] == np.float32(n_live.sum()) / np.float32(np.maximum(n_live, 1).sum())
    if case == "one_rank_all_dead":
        assert want[1] == np.float32(2.0) / np.float32(3.0)


def test_multi_sequence_mesh_with_ragged_blocks(suite, tmp_path):
    """Rank 1's sequences run out a chunk before rank 0's: it joins the
    last chunk's reduce with nothing to scan, and the run ends on both
    ranks with the unsharded run's trajectories."""
    streams = [s[:n] for s, n in zip(suite[1], (6, 6, 3, 2))]
    cfg = interop.sequential_config_from_fields(dataclasses.asdict(JSEQ_CFG))
    payload = {"cfg": dataclasses.asdict(JSEQ_CFG), "cameras": [(FX, FX, CX, CY)] * 4, "streams": streams,
               "chunk": SUITE_CHUNK}
    ranks = Ranks("suite", 2, payload, tmp_path)
    plain = sequences.MultiSequenceOdometry([Camera.create(FX, FX, CX, CY, device="cpu")] * 4, cfg,
                                            chunk=SUITE_CHUNK).run([iter(s) for s in streams])
    for r in ranks.results():
        assert r["fracs"] == [1.0, 1.0]  # two chunks: rank 1 has frames in the first only
        for which in ("run", "run_staged"):
            assert [len(t) for t in r[which]] == [6, 6, 3, 2]
            for got, want in zip(r[which], plain):
                assert max(_gap(a, b) for (_, a, _), (_, b, _) in zip(got, want)) < 1e-4


# ---------------------------------------------------------------------------
# full SLAM sharded over 2 ranks; a failing rank
# ---------------------------------------------------------------------------


def test_sharded_full_slam_with_loop_closure(tmp_path):
    S, N = 2, 60
    jcfg = JSequentialConfig(
        alignment=JAlignmentConfig(loss=JLossConfig(function="Huber"), min_gradient=20.0,
                                   solver=JSolverConfig(max_iterations=50, min_step_size=1e-7,
                                                        min_relative_reduction=1e-4),
                                   include_prior=True, prior_weight=(FX / 525.0) ** 2, interpolation="bilinear",
                                   max_points=512),
        n_levels=3, kf_period=4)
    streams, gts = [], []
    for s in range(S):
        scene = synthetic.BoxScene(seed=4 + s)
        poses = synthetic.loop_trajectory(N, extent=0.35, height=0.05, yaw=0.12)
        streams.append([(i * DT_NS, *(a.astype(np.float32) for a in synthetic.render_boxes(K, p, (H, W), scene)))
                        for i, p in enumerate(poses)])
        gts.append({i * DT_NS / 1e9: lie_np.inv(p) for i, p in enumerate(poses)})
    payload = {"cfg": dataclasses.asdict(jcfg), "cameras": [(FX, FX, CX, CY)] * S, "streams": streams, "chunk": 10}
    ranks = spawn("slam", S, payload, tmp_path)
    for rank, r in enumerate(ranks):
        s = r["sequence"]
        assert s == rank and r["untouched"] == [0]  # the other sequence's backend is not driven here
        assert [len(x) for x in r["results"]] == [N] * S
        assert r["n_closures"] >= 1, f"seq {s}: no loop closure fired"
        ate_online, _ = metrics.ate_rmse(gts[s], {t / 1e9: lie_np.inv(p) for t, p, _ in r["results"][s]})
        ate_corr, _ = metrics.ate_rmse(gts[s], {t / 1e9: lie_np.inv(p) for t, p, _ in r["corrected"]})
        assert ate_corr <= ate_online * 1.05, (s, ate_corr, ate_online)
        assert ate_corr < 0.05, (s, ate_corr)
    for a, b in zip(ranks[0]["results"], ranks[1]["results"]):
        assert all(np.array_equal(x[1], y[1]) for x, y in zip(a, b))


def test_a_failing_rank_fails_the_group(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn("fails", 2, None, tmp_path)
    assert time.monotonic() - t0 < GROUP_TIMEOUT_S
