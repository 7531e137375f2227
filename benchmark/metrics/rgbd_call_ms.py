"""rgbd_call_ms (ms): host milliseconds per ``RGBDProcessor.process(
fetch=False)`` call, the mean over the window's calls outside the profiled
stretch."""

import numpy as np


def read(run):
    spans = [t1 - t0 for t0, t1, traced in run.rgbd_spans if not traced]
    return float(np.mean(spans) * 1e3) if spans else None
