"""Bundle adjustment and pose-graph backends (the reference's
mapping::BundleAdjustment / Ceres, and the loop-closure graph)."""

from . import bundle_adjustment, pose_graph
from .bundle_adjustment import BaProblem, BundleAdjustment, solve_ba
from .pose_graph import PoseGraph, optimize_pose_graph

__all__ = ["bundle_adjustment", "pose_graph", "BaProblem", "BundleAdjustment", "solve_ba", "PoseGraph",
           "optimize_pose_graph"]
