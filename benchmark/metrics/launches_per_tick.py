"""launches_per_tick (launches/tick): the host's kernel-launch calls in the
profiled stretch (CUDA runtime events of the trace), over its processed
ticks; the RGB-D product's and the map's launches on their ticks count."""


def read(run):
    s = run.summary
    return s.launches / s.ticks if s is not None and s.ticks and s.launches else None
