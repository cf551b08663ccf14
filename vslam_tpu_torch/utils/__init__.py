"""Small helpers shared across the port."""

from . import log, timer
from .tree import tree_map

__all__ = ["log", "timer", "tree_map"]
