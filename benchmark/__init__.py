"""The benchmark of ``thor_slam_tpu_torch`` on an NVIDIA GPU (see README.md)."""
