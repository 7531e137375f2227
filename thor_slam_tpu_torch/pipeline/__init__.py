"""Host pipeline of the port: the pub/sub bus, the RGB-D product stream,
the engine's overlapped tick upload and the dense mapper."""

from thor_slam_tpu_torch.pipeline.bus import MessageBus, Topic
from thor_slam_tpu_torch.pipeline.rgbd import RGBDFrame, RGBDProcessor
from thor_slam_tpu_torch.pipeline.transfer import DoubleBufferedUploader

__all__ = ["DoubleBufferedUploader", "MessageBus", "RGBDFrame", "RGBDProcessor", "Topic"]
