"""Leaf-wise maps over the port's NamedTuple / tuple containers.

The JAX package leans on `jax.tree_util`; the port's containers (Frame,
Camera, SE3, ICLevelData) are NamedTuples of tensors, so a small recursive
map covers every use: stacking frames, adding a frame axis, moving state
between devices.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_map"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to corresponding leaves of ``tree`` and ``rest``.

    Tuples (NamedTuples included) are containers; everything else is a
    leaf. All trees must share the structure of ``tree``."""
    if isinstance(tree, tuple):
        children = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*children) if hasattr(tree, "_fields") else tuple(children)
    return fn(tree, *rest)
