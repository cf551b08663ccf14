"""Small helpers shared across the port."""

from . import log, timer
from .log import get_logger, log_img
from .tree import tree_map

__all__ = ["log", "timer", "tree_map", "pow2_bucket", "get_logger", "log_img"]


def pow2_bucket(n: int, minimum: int = 8) -> int:
    """Smallest power of two >= n, floored at ``minimum``: the shared policy
    for padding host-side counts (keypoints, observations, landmarks, graph
    nodes and edges) to a few sizes, as the JAX package does."""
    b = int(minimum)
    while b < n:
        b *= 2
    return b
