"""tick_rate (ticks/s): rig ticks whose pose reached the host in the window,
over the window's seconds. The window ends when ``flush()`` has drained the
pipeline, so the drain counts inside it; a tick that came back without a
pose (tracking lost) does not count."""


def read(run):
    return (len(run.calls) - run.failed) / run.window_s
