"""Entry points of the port: ``python -m thor_slam_tpu_torch.scripts.run_slam``
and ``python -m thor_slam_tpu_torch.scripts.run_pipeline``."""
