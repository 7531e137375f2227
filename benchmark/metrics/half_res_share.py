"""half_res_share (%): the window's ticks that shipped half-resolution
light images (the adaptive controller's degrade), from the difference of
``TorchSlamEngine.upload_stats`` over the window."""

from benchmark.core.traffic import payload_stats


def read(run):
    d = payload_stats(run.upload_after, run.upload_before)
    return 100.0 * d["light_half"] / d["ticks"] if d["ticks"] else None
