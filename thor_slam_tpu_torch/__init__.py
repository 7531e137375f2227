"""PyTorch + CUDA port of thor_slam_tpu: the stereo visual-odometry tick
and the RGB-D depth product.

The JAX package ``thor_slam_tpu`` is the reference this package is held
against. Modules mirror its layout (``ops/``, ``engine/``, ``pipeline/``,
``utils/``); the four TPU kernels (patch gather, FAST-9, the SGM path scan
and the SGM winner/LR pass) are hand-written CUDA C++ for Hopper under
``csrc/``. Nothing here imports ``jax`` or the JAX package: the host
layer it needs (``geometry``, ``camera/`` types, rig and synthetic
sources, the ``slam/`` interface, ``utils/evaluation``) is kept here as
copies of the reference's framework-free modules, under the same names.
"""
