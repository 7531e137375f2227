"""The plain reference the benchmark judges the program by.

Plain PyTorch and NumPy; imports neither JAX nor either package of the
repository. ``orbit``: the rig's ground-truth poses and IMU; ``stereo``: the
RGB-D product's depth; ``tsdf``: the dense map.
"""
