"""Concrete SLAM engine adapters (a copy of ``thor_slam_tpu.slam.adapters``)."""

from thor_slam_tpu_torch.slam.adapters.null_engine import NullSlamEngine

__all__ = ["NullSlamEngine", "ExternalRosEngine"]


def __getattr__(name):
    # Lazy: ExternalRosEngine imports rclpy message types at class-use
    # time only; importing the module is safe without ROS, but keep the
    # package import ROS-free regardless.
    if name == "ExternalRosEngine":
        from thor_slam_tpu_torch.slam.adapters.external_ros import ExternalRosEngine

        return ExternalRosEngine
    raise AttributeError(name)
