"""Small helpers shared across the port."""

from . import timer
from .tree import tree_map

__all__ = ["timer", "tree_map"]
