"""PyTorch + CUDA port of the thor_slam_tpu stereo visual-odometry tick.

The JAX package ``thor_slam_tpu`` is the reference this package is held
against. Modules mirror its layout (``ops/``, ``engine/``, ``utils/``);
the two hot-path TPU kernels are hand-written CUDA C++ for Hopper under
``csrc/``. Nothing here imports ``jax``: the package reuses only the
framework-free reference modules (geometry, camera types and sources, the
SLAM interface, trajectory evaluation).
"""
