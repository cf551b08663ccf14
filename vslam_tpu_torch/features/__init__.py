"""Feature detection, description, matching and tracking (reference
FeatureTracking / Matcher), and loop-closure place recognition."""

from . import descriptor, detector, loop_closure, matcher, tracking
from .tracking import FeatureTracking

__all__ = ["descriptor", "detector", "loop_closure", "matcher", "tracking", "FeatureTracking"]
