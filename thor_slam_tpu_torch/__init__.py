"""PyTorch + CUDA port of thor_slam_tpu: the stereo visual-odometry tick
and the RGB-D depth product.

The JAX package ``thor_slam_tpu`` is the reference this package is held
against. Modules mirror its layout (``ops/``, ``engine/``, ``pipeline/``,
``utils/``); the four TPU kernels (patch gather, FAST-9, the SGM path scan
and the SGM winner/LR pass) are hand-written CUDA C++ for Hopper under
``csrc/``. Nothing here imports ``jax``: the package reuses only the
framework-free reference modules (geometry, camera types and sources, the
SLAM interface, trajectory evaluation).
"""
