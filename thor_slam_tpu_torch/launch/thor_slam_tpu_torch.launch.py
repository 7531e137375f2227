"""ROS 2 launch: the port's SLAM bridge + map->odom TF completion.

Counterpart of the JAX package's ``launch/thor_slam_tpu.launch.py``, with
the same two processes, run from the port's package:

* ``thor_slam_tpu_torch.scripts.run_slam`` with ROS output enabled: tracks
  the rig on the CUDA device and publishes odometry on
  ``/visual_slam/tracking/odometry`` (the topic downstream consumers read);
* ``thor_slam_tpu_torch.scripts.publish_odom_tf``: completes the TF tree
  with map->odom.

The sync thresholds live in ``config/slam_config.yaml`` (rig queue
settings), the IMU noise densities are the defaults of
``thor_slam_tpu_torch.engine.backends.imu_fusion``.

Usage: ros2 launch thor_slam_tpu_torch/launch/thor_slam_tpu_torch.launch.py [config:=path.yaml]
"""

from launch import LaunchDescription  # type: ignore[import-not-found]
from launch.actions import DeclareLaunchArgument, ExecuteProcess  # type: ignore[import-not-found]
from launch.substitutions import LaunchConfiguration  # type: ignore[import-not-found]


def generate_launch_description() -> LaunchDescription:
    config = LaunchConfiguration("config")
    return LaunchDescription(
        [
            DeclareLaunchArgument(
                "config",
                default_value="config/slam_config.yaml",
                description="Runtime YAML config (cameras, rig, backend)",
            ),
            ExecuteProcess(
                cmd=["python", "-m", "thor_slam_tpu_torch.scripts.run_slam", "--config", config, "--ros"],
                name="thor_slam_tpu_torch",
                output="screen",
            ),
            ExecuteProcess(
                cmd=["python", "-m", "thor_slam_tpu_torch.scripts.publish_odom_tf"],
                name="odom_tf_publisher",
                output="screen",
            ),
        ]
    )
