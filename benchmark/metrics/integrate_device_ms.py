"""integrate_device_ms (ms): device milliseconds between CUDA events
recorded before and after each ``DenseMapper.integrate`` of the window
(outside the profiled stretch), the mean."""

import numpy as np


def read(run):
    ms = [i["ev0"].elapsed_time(i["ev1"]) for i in run.integrations
          if i["window"] and not i["traced"] and i["ev0"] is not None]
    return float(np.mean(ms)) if ms else None
