"""Entry points of the port: ``python -m thor_slam_tpu_torch.scripts.<name>``
with ``run_slam``, ``run_pipeline``, ``run_euroc`` and ``make_euroc_synthetic``
(the accuracy path), ``find_cameras`` and ``publish_odom_tf``."""
