"""Small helpers shared across the port."""

from .tree import tree_map

__all__ = ["tree_map"]
