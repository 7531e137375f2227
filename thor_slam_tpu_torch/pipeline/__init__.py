"""Host pipeline of the port: the RGB-D product stream."""

from thor_slam_tpu_torch.pipeline.rgbd import RGBDFrame, RGBDProcessor

__all__ = ["RGBDFrame", "RGBDProcessor"]
