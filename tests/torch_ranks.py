"""Rank bodies of the port's multi-process tests, and the spawner that runs
them: one process a rank, joined over gloo on the CPU through a file
store in the test's temporary directory.

This module imports torch and the port only (no jax, no vslam_tpu), so a
rank process never loads JAX; the tests hand each body its inputs as
numpy trees and compare what it returns with the JAX functions in the
parent. Each rank runs torch on one thread.

    results = spawn("tracking", 4, payload, tmp_path)  # one result a rank, in rank order

A rank that raises makes `spawn` raise, with every failed rank's error,
as soon as it exits; a run that outlasts ``timeout`` is killed and raises.
"""

from __future__ import annotations

import datetime
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
# how long a rank's collective waits for the others before it fails
GROUP_TIMEOUT_S = 60


class Ranks:
    """``body`` (a function of this module) running in ``world`` rank
    processes on ``payload``; `results` waits for them. Starting the ranks
    before the parent's own work lets the two overlap."""

    def __init__(self, body: str, world: int, payload, tmp_path, timeout: float = 150.0):
        self.body, self.world = body, world
        self.tmp = Path(tmp_path) / f"{body}-{world}"
        self.tmp.mkdir(parents=True, exist_ok=True)
        (self.tmp / "payload.pkl").write_bytes(pickle.dumps(payload))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]), OMP_NUM_THREADS="1")
        self.deadline = time.monotonic() + timeout
        self.procs = []
        for rank in range(world):
            with open(self.tmp / f"err{rank}.txt", "w") as err:
                self.procs.append(subprocess.Popen([sys.executable, __file__, body, str(rank), str(world),
                                                    str(self.tmp)], env=env, stdout=subprocess.DEVNULL,
                                                   stderr=err))

    def results(self):
        """Each rank's result, in rank order."""
        procs = self.procs
        try:
            while any(p.poll() is None for p in procs) and not any(p.returncode for p in procs):
                if time.monotonic() > self.deadline:
                    raise TimeoutError(f"{self.body}: the ranks ran past their time limit")
                time.sleep(0.05)
            # a failed rank breaks the others' collectives: give them a moment
            # to exit on their own, then report every rank that failed
            grace = time.monotonic() + 5.0
            while any(p.poll() is None for p in procs) and time.monotonic() < grace:
                time.sleep(0.05)
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed:
                tails = "".join(f"\n--- rank {r} exited with {procs[r].returncode}:\n"
                                f"{(self.tmp / f'err{r}.txt').read_text()[-2000:]}" for r in failed)
                raise RuntimeError(f"{self.body}: ranks {failed} failed{tails}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return [pickle.loads((self.tmp / f"out{rank}.pkl").read_bytes()) for rank in range(self.world)]


def spawn(body: str, world: int, payload, tmp_path, timeout: float = 150.0):
    """`Ranks(...).results()`: run ``body`` in ``world`` ranks and wait."""
    return Ranks(body, world, payload, tmp_path, timeout).results()


def _np(tree):
    """A tree of tensors as numpy arrays (the port's containers are tuples)."""
    import torch

    if isinstance(tree, tuple):
        children = [_np(x) for x in tree]
        return type(tree)(*children) if hasattr(tree, "_fields") else tuple(children)
    if isinstance(tree, list):
        return [_np(x) for x in tree]
    return tree.numpy() if torch.is_tensor(tree) else tree


# ---------------------------------------------------------------------------
# Rank bodies: (rank, world, payload) -> a picklable result
# ---------------------------------------------------------------------------


def layouts(rank, world, tree):
    """Each layout's block of ``tree`` (a global batched tree of arrays)."""
    from vslam_tpu_torch.parallel import batched, multihost

    mesh = batched.make_mesh(device="cpu")
    mesh2 = multihost.dcn_ici_mesh(n_hosts=2, device="cpu")
    nodes = multihost.dcn_ici_mesh(device="cpu")  # rows by host name: one node here
    local = multihost.shard_sequences(len(tree[0]))  # rank and world from the group
    try:
        batched.shard_batch(np.zeros(world + 2), mesh)
        not_divisible = None
    except ValueError as exc:
        not_divisible = str(exc)
    return {
        "coordinate": mesh.get_coordinate(),
        "coordinate_2d": mesh2.get_coordinate(),
        "shard_batch": _np(batched.shard_batch(tree, mesh)),
        "shard_batch_2d": _np(multihost.shard_batch_2d(tree, mesh2)),
        "host_local_to_global": _np(multihost.host_local_to_global(
            tuple(x[local.start:local.stop] if np.ndim(x) else x for x in tree), mesh2)),
        "nodes_shape": tuple(nodes.mesh.shape),
        "shard_sequences": (local.start, local.stop),
        "not_divisible": not_divisible,
    }


def _tracking_inputs(payload):
    """((ekf, ref, cur, dt), cfg) of the port from the payload's numpy trees."""
    import torch

    from vslam_tpu_torch import interop

    ekf = interop.ekf_state_from_numpy(payload["ekf"], device="cpu")
    ref = interop.frame_from_numpy(payload["ref"], device="cpu")
    cur = interop.frame_from_numpy(payload["cur"], device="cpu")
    return (ekf, ref, cur, torch.tensor(payload["dt"])), interop.alignment_config_from_fields(payload["cfg"])


def tracking(rank, world, payload):
    """`sharded_tracking_step` on a 1-D mesh and `sharded_tracking_step_2d`
    on a (2, world / 2) mesh, each on this rank's block of the global batch."""
    from vslam_tpu_torch.parallel import batched, multihost

    args, cfg = _tracking_inputs(payload)
    mesh = batched.make_mesh(device="cpu")
    out = batched.sharded_tracking_step(mesh, cfg)(*batched.shard_batch(args, mesh))
    mesh2 = multihost.dcn_ici_mesh(n_hosts=2, device="cpu")
    out2 = multihost.sharded_tracking_step_2d(mesh2, cfg)(*multihost.shard_batch_2d(args, mesh2))
    return {"1d": _np(out), "2d": _np(out2)}


def _suite_inputs(payload):
    """(cfg, cameras) of the port from the payload's fields."""
    from vslam_tpu_torch import interop
    from vslam_tpu_torch.core.camera import Camera

    cfg = interop.sequential_config_from_fields(payload["cfg"])
    cams = [Camera.create(*c, device="cpu") for c in payload["cameras"]]
    return cfg, cams


def suite(rank, world, payload):
    """`MultiSequenceOdometry(mesh=)` `run` and `run_staged` over all S
    streams, and `sharded_scan_sequences` alone on this rank's first chunk."""
    from vslam_tpu_torch.parallel import batched, sequences

    cfg, cams = _suite_inputs(payload)
    streams, chunk = payload["streams"], payload["chunk"]
    mesh = batched.make_mesh(device="cpu")
    odo = sequences.MultiSequenceOdometry(cams, cfg, chunk=chunk, mesh=mesh)
    run = odo.run([iter(s) for s in streams])
    fracs = list(odo.fracs)
    firsts, chunks = odo.stage_streams([iter(s) for s in streams])
    staged = odo.run_staged(firsts, chunks)

    from vslam_tpu_torch.odometry.sequential import _upload

    i0 = np.stack([f[1] for f in firsts])
    d0 = np.stack([f[2] for f in firsts])
    states = sequences.init_states(_upload(i0, "cpu"), _upload(d0, "cpu"), odo.cameras, cfg)
    c = chunks[0]
    out = sequences.sharded_scan_sequences(mesh, cfg)(states, c.intensity, c.depth, c.dts, c.live, odo.cameras)
    return {"run": run, "run_staged": staged, "fracs": fracs, "block": (odo._block.start, odo._block.stop),
            "scan": {"R": out[1].R.numpy(), "t": out[1].t.numpy(), "valid": out[2].numpy(),
                     "frac": float(out[5])}}


def scan_chunk(rank, world, payload):
    """`sharded_scan_sequences` on this rank's block of one (S, K) chunk,
    once for each of the payload's live masks: (valid, frac) of each."""
    from vslam_tpu_torch.parallel import batched, sequences

    cfg, cams = _suite_inputs(payload)
    mesh = batched.make_mesh(device="cpu")
    i0, d0, inten, depth, dts, cameras = batched.shard_batch(
        (payload["i0"], payload["d0"], payload["intensity"], payload["depth"], payload["dts"],
         sequences.stack_cameras(cams, "cpu")), mesh)
    step = sequences.sharded_scan_sequences(mesh, cfg)
    out = []
    for live in payload["lives"]:
        states = sequences.init_states(i0, d0, cameras, cfg)
        got = step(states, inten, depth, dts, batched.shard_batch(live, mesh), cameras)
        out.append({"valid": got[2].numpy(), "frac": float(got[5])})
    return out


def slam(rank, world, payload):
    """Full SLAM sharded one sequence a rank: the trajectories of all S,
    and this rank's backend's closures and anchored trajectory."""
    from vslam_tpu_torch.features.loop_closure import LoopClosureConfig
    from vslam_tpu_torch.features.tracking import FeatureTracking
    from vslam_tpu_torch.odometry.sequential_mapping import ChunkMappingBackend
    from vslam_tpu_torch.parallel import batched, sequences

    cfg, cams = _suite_inputs(payload)
    streams = payload["streams"]
    backends = [ChunkMappingBackend(enable_ba=True, enable_loop_closure=True,
                                    tracking=FeatureTracking(grid_cell=12, device="cpu"),
                                    loop_closure_cfg=LoopClosureConfig(min_gap=4, min_matches=10, min_inliers=8),
                                    device="cpu") for _ in streams]
    mesh = batched.make_mesh(device="cpu")
    odo = sequences.MultiSequenceOdometry(cams, cfg, chunk=payload["chunk"], mappings=backends, mesh=mesh)
    res = odo.run([iter(s) for s in streams])
    mine = odo._block.start
    return {"results": res, "sequence": mine, "n_closures": backends[mine].n_closures,
            "untouched": [len(b.map.keyframes()) for s, b in enumerate(backends) if s != mine],
            "corrected": backends[mine].corrected_trajectory(res[mine])}


def fails(rank, world, payload):
    """Rank 1 raises; the others wait in a collective."""
    import torch
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1))
    return None


def _main(body, rank, world, tmp):
    import torch

    torch.set_num_threads(1)
    from vslam_tpu_torch.parallel import multihost

    tmp = Path(tmp)
    payload = pickle.loads((tmp / "payload.pkl").read_bytes())
    multihost.initialize(f"file://{tmp / 'store'}", world, rank, device="cpu",
                         timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    import torch.distributed as dist

    try:
        result = globals()[body](rank, world, payload)
    finally:
        dist.destroy_process_group()
    (tmp / f"out{rank}.pkl").write_bytes(pickle.dumps(result))


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
