"""Stage a synchronized frame set as one dense (C, 2, H, W) host array.

The port of ``TpuSlamEngine._stage_list``'s ordering rules: sources in
``source_order``, left then right imager; a source with no frame this tick
(a watchdog-stale camera that never delivered) is zero-filled and masked
out of the solve by the engine. uint8 frames stay uint8, normalized on the
device.
"""

from __future__ import annotations

import numpy as np

from thor_slam_tpu_torch.camera.types import SynchronizedFrameSet


def stage_images(
    frame_set: SynchronizedFrameSet, source_order: list[str], zero: np.ndarray
) -> np.ndarray:
    """(C, 2, H, W) array of the tick's images; ``zero`` fills missing frames."""
    flat: list[np.ndarray] = []
    for name in source_order:
        fs = frame_set.frame_sets.get(name)
        imgs = [] if fs is None else [np.asarray(f.image) for f in fs.frames[:2]]
        imgs.extend([zero] * (2 - len(imgs)))
        flat.extend(imgs)
    dtype = flat[0].dtype if all(im.dtype == flat[0].dtype for im in flat) else np.float32
    return np.stack(flat).astype(dtype, copy=False).reshape(len(source_order), 2, *zero.shape)
