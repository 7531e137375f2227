"""pose_latency_p95_ms (ms): the 95th percentile, over every tick of the
window whose pose came back, of the time from its frames' capture on the
camera clock to the return of ``process_frames`` or ``flush`` that handed
its pose over. Frames the newest-wins rig dropped are no requests."""

import numpy as np


def read(run):
    if not run.clock.paced or not run.poses:
        return None
    return float(np.percentile([t - run.capture_time(k) for k, t, _ in run.poses], 95) * 1e3)
