"""map_latency_p90_ms (ms): the 90th percentile, over every RGB-D frame the
window integrated, of the time from its tick's capture on the camera clock
to the completion on the device of its ``DenseMapper.integrate`` (a CUDA
event recorded behind it, placed on the host's clock by an anchor event)."""

import numpy as np


def read(run):
    lat = [run.completion_time(i["ev1"]) - run.capture_time(i["k"])
           for i in run.integrations if i["window"] and i["ev1"] is not None]
    if not run.clock.paced or not lat:
        return None
    return float(np.percentile(lat, 90) * 1e3)
