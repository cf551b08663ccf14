"""Checkpoint / resume of mid-sequence tracking state.

Port of `vslam_tpu.utils.checkpoint`, in its .npz layout: the scan's
`SequentialState` as ``leaf_{i}`` arrays in a fixed leaf order
(`utils.tree.tree_leaves`), the stream clock ``t_last_ns``, and a landmark
map as ``positions`` (N, 3) with its ids and observations as JSON ``meta``.

The port's state has a leading sequence axis S on every leaf (the JAX
package's has none), so a state file holds to its own package:
`load_sequential` reads what `save_sequential` wrote and refuses, with a
ValueError, a leaf whose shape or dtype differs from ``state_like``'s.
numpy has no bfloat16, so a bf16 leaf (the bf16 profiles' cached
templates) is stored as its 16-bit pattern and the file records every
leaf's torch dtype in ``leaf_dtypes``; it comes back bit for bit. Landmark
files are the JAX package's, and either package reads the other's.
"""

from __future__ import annotations

import json
from typing import List, Tuple

import numpy as np
import torch

from .tree import tree_leaves, tree_unflatten

__all__ = ["save_sequential", "load_sequential", "save_landmarks", "load_landmarks"]


def _to_host(leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    """Host copies of the leaves: those on CUDA are copied into pinned
    memory without waiting, then the host waits once, for the last copy."""
    host, event = [], None
    for x in leaves:
        if x.is_cuda:
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            h.copy_(x, non_blocking=True)
            x, event = h, torch.cuda.Event()
        host.append(x)
    if event is not None:
        event.record()
        event.synchronize()
    return host


def save_sequential(path: str, state, t_last_ns: int) -> None:
    """Snapshot a `SequentialState` (+ stream clock) to ``path`` (.npz)."""
    leaves = _to_host([torch.as_tensor(x) for x in tree_leaves(state)])
    arrays = {}
    for i, x in enumerate(leaves):
        arrays[f"leaf_{i}"] = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    arrays["leaf_dtypes"] = np.asarray(json.dumps([str(x.dtype).removeprefix("torch.") for x in leaves]))
    arrays["t_last_ns"] = np.asarray(int(t_last_ns), np.int64)
    np.savez_compressed(path, **arrays)


def load_sequential(path: str, state_like) -> Tuple[object, int]:
    """Restore a `SequentialState` saved by :func:`save_sequential`.

    ``state_like`` gives the structure, shapes, dtypes and device (a fresh
    `init_state(...)` with the same geometry and configuration, on the card
    by default); a leaf that differs in shape or dtype raises ValueError.
    Returns (state, t_last_ns)."""
    likes = tree_leaves(state_like)
    with np.load(path, allow_pickle=False) as data:
        if "leaf_dtypes" not in data.files:
            raise ValueError(f"{path} is not a state written by save_sequential (no leaf_dtypes)")
        dtypes = json.loads(str(data["leaf_dtypes"]))
        if len(dtypes) != len(likes):
            raise ValueError(f"checkpoint holds {len(dtypes)} leaves, the state {len(likes)}")
        leaves = []
        for i, (like, name) in enumerate(zip(likes, dtypes)):
            arr = data[f"leaf_{i}"]
            dtype = getattr(torch, name, None)
            if tuple(arr.shape) != tuple(like.shape) or dtype != like.dtype:
                raise ValueError(f"checkpoint leaf {i}: shape {tuple(arr.shape)} dtype {name}, expected "
                                 f"{tuple(like.shape)} {str(like.dtype).removeprefix('torch.')}")
            t = torch.from_numpy(arr)
            if dtype == torch.bfloat16:
                t = t.view(torch.bfloat16)
            leaves.append(t.pin_memory().to(like.device, non_blocking=True) if like.is_cuda else t.to(like.device))
        t_last = int(data["t_last_ns"])
    return tree_unflatten(state_like, leaves), t_last


def save_landmarks(path: str, landmarks) -> None:
    """Persist a landmark list (`odometry.map.Landmark`) to ``path`` (.npz):
    positions as one (N, 3) array, ids and observation maps as JSON."""
    positions = (np.stack([np.asarray(lm.position, np.float64) for lm in landmarks]) if landmarks
                 else np.zeros((0, 3)))
    meta = [{"id": int(lm.id), "observations": {str(k): int(v) for k, v in lm.observations.items()}}
            for lm in landmarks]
    np.savez_compressed(path, positions=positions, meta=json.dumps(meta))


def load_landmarks(path: str):
    """Rebuild the landmark list saved by :func:`save_landmarks` (or by the
    JAX package's)."""
    from ..odometry.map import Landmark

    with np.load(path, allow_pickle=False) as data:
        positions = data["positions"]
        meta = json.loads(str(data["meta"]))
    return [Landmark(position=pos.copy(), observations={int(k): int(v) for k, v in m["observations"].items()},
                     id=int(m["id"]))
            for pos, m in zip(positions, meta)]
