"""Host pipeline of the port: the RGB-D product stream and the engine's
overlapped tick upload."""

from thor_slam_tpu_torch.pipeline.rgbd import RGBDFrame, RGBDProcessor
from thor_slam_tpu_torch.pipeline.transfer import DoubleBufferedUploader

__all__ = ["DoubleBufferedUploader", "RGBDFrame", "RGBDProcessor"]
