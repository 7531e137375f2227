"""engine_call_ms (ms): host milliseconds per ``process_frames`` call, the
mean over the window's calls outside the profiled stretch (the driver's
span around each call)."""

import numpy as np


def read(run):
    calls = [c["t1"] - c["t0"] for c in run.calls if not c["traced"]]
    return float(np.mean(calls) * 1e3) if calls else None
