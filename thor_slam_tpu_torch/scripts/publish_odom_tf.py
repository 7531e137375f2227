"""Broadcast map->odom TF from SLAM odometry (port of the JAX package's
scripts/publish_odom_tf.py, which follows the reference's).

The math (pure, unit-tested): given the robot pose in the map frame,
map_T_odom = pose * inverse so that odom remains the robot-local frame:
``map_T_odom = (R^T, -R^T t)`` inverted composition (reference
publish_odom_tf.py:72-86). Runs as a ROS 2 node when rclpy is available;
otherwise exposes the pure function for in-process consumers.

Usage: python -m thor_slam_tpu_torch.scripts.publish_odom_tf
"""

from __future__ import annotations

import sys

import numpy as np

from thor_slam_tpu_torch.geometry import se3_inverse


def map_t_odom_from_pose(map_t_base: np.ndarray) -> np.ndarray:
    """map->odom transform given base_link's pose in map.

    With odom defined so that odom_T_base == identity at this instant,
    map_T_odom = map_T_base @ inv(odom_T_base) = map_T_base; the reference
    broadcasts the INVERSE pose when odometry is already map-frame
    (reference publish_odom_tf.py:59-96): odom_T_map = inv(map_T_base).
    """
    return se3_inverse(np.asarray(map_t_base, np.float64))


def main() -> int:
    try:
        import rclpy
        from geometry_msgs.msg import TransformStamped
        from nav_msgs.msg import Odometry
        from rclpy.node import Node
        from tf2_ros import TransformBroadcaster
    except ImportError:
        print("rclpy not installed — ROS TF bridging unavailable. "
              "In-process consumers: use map_t_odom_from_pose().")
        return 1

    from thor_slam_tpu_torch.geometry import matrix_to_quat, se3_from_pose

    class OdomTF(Node):
        def __init__(self):
            super().__init__("thor_slam_tpu_odom_tf")
            self._br = TransformBroadcaster(self)
            self.create_subscription(Odometry, "/visual_slam/tracking/odometry", self._cb, 10)

        def _cb(self, msg):
            q = msg.pose.pose.orientation
            p = msg.pose.pose.position
            pose = se3_from_pose(
                np.array([p.x, p.y, p.z]), np.array([q.x, q.y, q.z, q.w])
            )
            inv = map_t_odom_from_pose(pose)
            quat = matrix_to_quat(inv[:3, :3])
            t = TransformStamped()
            t.header.stamp = msg.header.stamp
            t.header.frame_id = "map"
            t.child_frame_id = "odom"
            t.transform.translation.x, t.transform.translation.y, t.transform.translation.z = inv[:3, 3]
            t.transform.rotation.x, t.transform.rotation.y, t.transform.rotation.z, t.transform.rotation.w = quat
            self._br.sendTransform(t)

    rclpy.init()
    node = OdomTF()
    try:
        rclpy.spin(node)
    except KeyboardInterrupt:
        pass
    finally:
        node.destroy_node()
        rclpy.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
