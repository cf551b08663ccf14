"""Live visualization: the reference's RViz channel, rebuilt without ROS
(port of `vslam_tpu.viz`).

The reference node publishes nav_msgs /odom (pose + covariance + twist),
nav_msgs /path and a TF transform for RViz consumption
(reference src/ros/nodes/NodeMapping.cpp:231-272, config/rviz/odom_eval.rviz).
This package provides the same live affordance as a zero-dependency
in-process HTTP server: a JSON state endpoint (the message bus) and a
self-contained browser page (the RViz view).
"""

from .live import LiveViz

__all__ = ["LiveViz"]
