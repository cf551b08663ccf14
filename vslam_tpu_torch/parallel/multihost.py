"""Several nodes: the process group, the (host, data) mesh, each rank's
share of the sequences (port of `vslam_tpu.parallel.multihost`).

The port runs one process a GPU (a rank). `initialize` joins the ranks
into one `torch.distributed` process group; `dcn_ici_mesh` lays them on a
2-D `DeviceMesh` (host, data), one row a node, so the inner axis never
leaves a node; a reduction over both axes runs within each node first and
then crosses the nodes with one small tensor (`sharded_tracking_step_2d`).
Frame data never crosses ranks: each rank loads its own sequences
(`shard_sequences`) and passes its local block (`host_local_to_global`).

    torchrun --nnodes 2 --nproc-per-node 4 ... script.py  # on each node
    multihost.initialize()  # reads RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT
    mesh = multihost.dcn_ici_mesh()
    step = multihost.sharded_tracking_step_2d(mesh, cfg)

``dcn_ici_mesh(n_hosts=k)`` folds a flat world into k rows, so the
two-axis program runs on one node too (the tests run it over gloo on the
CPU).
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..alignment.ic import AlignmentConfig
from ..utils.tree import tree_map
from . import mesh as mesh_lib
from .batched import _sharded_step

__all__ = [
    "initialize",
    "dcn_ici_mesh",
    "shard_sequences",
    "shard_batch_2d",
    "host_local_to_global",
    "sharded_tracking_step_2d",
]

# how long a collective may wait for the other ranks before it fails
DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)


def _env_int(name: str, given: Optional[int]) -> int:
    if given is not None:
        return int(given)
    if name not in os.environ:
        raise ValueError(f"initialize: {name} is not set and no value was given (torchrun sets RANK, "
                         "WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT)")
    return int(os.environ[name])


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    *,
    device=None,
    backend: Optional[str] = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> torch.device:
    """Join this process to the group as rank ``process_id`` of
    ``num_processes``; call once per process, before any collective.

    ``coordinator_address`` is "host:port" (a TCP store there) or an
    init-method URL such as "file:///path"; it and the counts default from
    torchrun's MASTER_ADDR / MASTER_PORT, WORLD_SIZE and RANK.
    ``local_device_ids[0]`` (else LOCAL_RANK, else 0) picks this rank's GPU.
    With ``device`` None the rank runs on that GPU over NCCL and raises
    without CUDA; ``device="cpu"`` runs it on the CPU over gloo.
    ``backend`` overrides the choice (gloo lets two ranks share one card,
    which NCCL refuses). A collective that waits longer than ``timeout``
    fails. Returns the rank's device."""
    rank = _env_int("RANK", process_id)
    world = _env_int("WORLD_SIZE", num_processes)
    if coordinator_address is None:
        coordinator_address = f"{os.environ.get('MASTER_ADDR', 'localhost')}:{_env_int('MASTER_PORT', None)}"
    local = int(local_device_ids[0]) if local_device_ids else int(os.environ.get("LOCAL_RANK", 0))
    dev = mesh_lib.rank_device(device, local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank, timeout=timeout)
    return dev


def dcn_ici_mesh(
    n_hosts: Optional[int] = None,
    devices=None,
    axis_dcn: str = "host",
    axis_ici: str = "data",
    device=None,
):
    """The (host, data) `DeviceMesh`: one row a node, the inner axis within
    it. ``devices`` lists the ranks (every rank of the group when None).
    With ``n_hosts`` None the rows are the nodes, found by gathering each
    rank's host name; ``n_hosts=k`` folds the ranks in order into k rows,
    the single-node test mode. ``device`` as in `batched.make_mesh`."""
    from torch.distributed.device_mesh import DeviceMesh

    device_type = mesh_lib.rank_device(device).type
    mesh_lib.require_group("dcn_ici_mesh")
    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    if n_hosts is None:
        names = [None] * dist.get_world_size()
        dist.all_gather_object(names, socket.gethostname())
        nodes = list(dict.fromkeys(names[r] for r in ranks))
        rows = [[r for r in ranks if names[r] == node] for node in nodes]
        if len({len(row) for row in rows}) != 1:
            raise ValueError(f"uneven nodes: ranks per node {[len(row) for row in rows]}")
    else:
        if len(ranks) % n_hosts:
            raise ValueError(f"{len(ranks)} ranks do not fold into {n_hosts} rows")
        per = len(ranks) // n_hosts
        rows = [ranks[h * per:(h + 1) * per] for h in range(n_hosts)]
    return DeviceMesh(device_type, rows, mesh_dim_names=(axis_dcn, axis_ici))


def shard_sequences(
    n_sequences: int,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> range:
    """This rank's slice of the sequence list: a contiguous block, the
    remainder spread over the first ranks. In the port each rank process
    loads its own streams, so the defaults are this rank and the world
    size (the JAX package's are the host's process index and count); they
    need an initialized group."""
    if process_index is None or process_count is None:
        mesh_lib.require_group("shard_sequences without an explicit index and count")
    p = dist.get_rank() if process_index is None else process_index
    n = dist.get_world_size() if process_count is None else process_count
    base, rem = divmod(n_sequences, n)
    start = p * base + min(p, rem)
    return range(start, start + base + (1 if p < rem else 0))


def _flat_index(mesh, axis_dcn: str, axis_ici: str):
    """(block, blocks) of this rank over both axes, host-major."""
    per_host = mesh_lib.axis_size(mesh, axis_ici)
    index = mesh_lib.axis_index(mesh, axis_dcn) * per_host + mesh_lib.axis_index(mesh, axis_ici)
    return index, mesh_lib.axis_size(mesh, axis_dcn) * per_host


def shard_batch_2d(tree, mesh, axis_dcn: str = "host", axis_ici: str = "data"):
    """This rank's block of a batched tree that every rank holds whole,
    split over both mesh axes host-major: block ``host * per_host + data``,
    on the rank's device; 0-dim leaves are replicated."""
    index, count = _flat_index(mesh, axis_dcn, axis_ici)
    device = mesh_lib.mesh_device(mesh)
    return tree_map(lambda x: mesh_lib.block(x, index, count, device), tree)


def host_local_to_global(tree, mesh, axis_dcn: str = "host", axis_ici: str = "data"):
    """Each rank passes its LOCAL batch (its `shard_sequences` slice) and
    gets it back on its device: the global batch is the union of the
    ranks' blocks in rank order, the layout `shard_batch_2d` gives. No data
    crosses ranks."""
    _flat_index(mesh, axis_dcn, axis_ici)  # this rank must be on the mesh
    device = mesh_lib.mesh_device(mesh)
    return tree_map(lambda x: mesh_lib.block(x, 0, 1, device), tree)


def sharded_tracking_step_2d(
    mesh,
    cfg: AlignmentConfig,
    axis_dcn: str = "host",
    axis_ici: str = "data",
):
    """The tracking step over a (host, data) mesh: a callable ``(ekf, ref,
    cur, dt)`` on this rank's blocks returning ``(ekf, rel, valid, frac)``.
    The solves are the rank's own; ``frac`` is reduced in two stages, over
    ``axis_ici`` within the node, then over ``axis_dcn`` across nodes."""
    return _sharded_step(mesh, cfg, (axis_ici, axis_dcn))
