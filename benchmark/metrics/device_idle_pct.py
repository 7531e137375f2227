"""device_idle_pct (%): the share of the profiled stretch in which no
operation ran on the device (the union of its kernels, copies and sets)."""


def read(run):
    s = run.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
