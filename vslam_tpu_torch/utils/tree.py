"""Leaf-wise maps over the port's NamedTuple / tuple containers.

The JAX package leans on `jax.tree_util`; the port's containers (Frame,
Camera, SE3, ICLevelData) are NamedTuples of tensors, so a small recursive
map covers every use: stacking frames, adding a frame axis, moving state
between devices; flattening a state to a fixed order of leaves and back
(`utils.checkpoint`).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List

__all__ = ["tree_map", "tree_leaves", "tree_unflatten"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to corresponding leaves of ``tree`` and ``rest``.

    Tuples (NamedTuples included) are containers; everything else is a
    leaf. All trees must share the structure of ``tree``."""
    if isinstance(tree, tuple):
        children = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*children) if hasattr(tree, "_fields") else tuple(children)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in depth-first order, fields in declaration
    order; None is an empty subtree, as in `jax.tree_util`."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [leaf for child in tree for leaf in tree_leaves(child)]
    return [tree]


def tree_unflatten(like: Any, leaves: Iterable[Any]) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in the order
    `tree_leaves` gives them."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, tuple):
            children = [build(c) for c in node]
            return type(node)(*children) if hasattr(node, "_fields") else tuple(children)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out
