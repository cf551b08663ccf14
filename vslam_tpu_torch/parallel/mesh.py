"""A rank's device, its place on a device mesh, and the mesh's collectives.

The port runs one process per GPU (one *rank*); a mesh is a
`torch.distributed.device_mesh.DeviceMesh` over ranks, and a sharded batch
is the rank's own contiguous block of the leading axis, a plain tensor on
its device: the block that `NamedSharding(mesh, P(axis))` gives the device
at the same mesh coordinate in the JAX package. The kernels are ctypes
calls on raw pointers, so nothing here goes through DTensor.

A group on CUDA uses NCCL with each rank on ``cuda:{local_rank}``; a group
named on the CPU (``device="cpu"``) uses gloo. With no device named and no
CUDA, `rank_device` raises: there is no quiet fallback to the CPU, and a
reduction over a mesh raises where no process group exists instead of
becoming a local sum.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["rank_device", "require_group", "mesh_device", "axis_size", "axis_index", "block", "all_reduce_sum",
           "global_fraction"]


def rank_device(device=None, local_rank: int = 0) -> torch.device:
    """``device`` as named, else ``cuda:{local_rank}``; without CUDA the
    default raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a rank runs on its GPU unless device='cpu' is named "
                           "(there is no CPU fallback)")
    return torch.device("cuda", local_rank)


def require_group(what: str) -> None:
    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs an initialized process group: call "
                           "vslam_tpu_torch.parallel.multihost.initialize() in every rank first "
                           "(torchrun sets the environment it reads)")


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: its current CUDA device on a CUDA
    mesh (`multihost.initialize` sets it), else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``; a rank outside the mesh raises."""
    if mesh.get_coordinate() is None:
        raise RuntimeError(f"rank {dist.get_rank()} is not on the mesh {mesh.mesh.tolist()}")
    return mesh.get_local_rank(axis)


def block(x, index: int, count: int, device: torch.device):
    """Block ``index`` of ``count`` along the leading axis of a tensor or
    array, on ``device``; a 0-dim leaf is replicated and a non-array leaf
    passes as it is. A leading axis that ``count`` does not divide raises,
    as `jax.device_put` does."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        x = torch.as_tensor(x)
        if x.dim() == 0:
            return x.to(device)
        n = x.shape[0]
        if n % count:
            raise ValueError(f"the leading axis of a {tuple(x.shape)} leaf does not split into {count} "
                             "equal blocks over the mesh axis")
        size = n // count
        return x[index * size:(index + 1) * size].to(device)
    return x


def all_reduce_sum(values: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """``values`` summed over the ranks of ``mesh``, one `all_reduce` a mesh
    axis in the order given (the first within a node, the next across
    nodes), on ``values``' device. A gloo group reduces a host copy."""
    require_group("a reduction over a mesh")
    out = values.clone()
    for axis in axes:
        group = mesh.get_group(axis)
        if dist.get_backend(group) == "nccl":
            dist.all_reduce(out, group=group)
        else:
            host = out.cpu()
            dist.all_reduce(host, group=group)
            out = host.to(values.device)
    return out


def global_fraction(n_ok: torch.Tensor, n, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Σ n_ok / Σ n over the mesh in f32, both counts in one tensor so one
    collective a mesh axis serves; ``n`` a tensor or a number. A 0-dim
    tensor on ``n_ok``'s device, the same on every rank."""
    n_ok = n_ok.to(torch.float32)
    n = n.to(torch.float32) if torch.is_tensor(n) else torch.full_like(n_ok, float(n))
    counts = all_reduce_sum(torch.stack((n_ok, n)), mesh, axes)
    return counts[0] / counts[1]
