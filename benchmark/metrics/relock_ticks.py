"""relock_ticks (ticks): camera frames (ticks of the mix's clock, frame k at
k / fps) from the lights-out's end (``blackout_s``: the first lit frame)
until the frame of the first call whose tracking state is ``TRACKING``
again, after tracking left it in the lights-out: the ``state`` attribute
of each ``engine.process_frames`` span (the state the call left), over
the untraced ticks of a traced run. Counted on the camera clock, not in
calls, so that a slower host, which drops more frames, reads the same
relock; the lights-out's own length is not in it. 0 where tracking never
left ``TRACKING``; nothing to read where the window holds no lights-out,
the state never came back, or the program's spans carry no ``state``.

Importing this reader turns the program's tracer on; only a traced run
imports it (``benchmark.core.program_spans``)."""

import bisect
import math

from benchmark.core import program_spans

program_spans.turn_on()


def read(run):
    blackout = run.traffic.get("blackout_s")
    ticks = program_spans.window_ticks(run)
    if not blackout or not any("state" in t.root.attrs for t in ticks):
        return None
    calls = sorted((c["t0"], c["k"]) for c in run.calls)
    starts = [t0 for t0, _ in calls]
    fps = float(run.traffic["fps"])
    ks = [calls[bisect.bisect_right(starts, t.root.t0 / 1e9) - 1][1] for t in ticks]
    first = next((i for i, k in enumerate(ks) if k / fps >= blackout[0]), None)
    if first is None or ks[first] / fps >= blackout[1]:
        return None
    states = [t.root.attrs.get("state") for t in ticks]
    left = next((i for i in range(first, len(ticks)) if states[i] != "TRACKING"), None)
    if left is None:
        return 0.0
    back = next((i for i in range(left, len(ticks)) if states[i] == "TRACKING"), None)
    return None if back is None else float(ks[back] - math.ceil(blackout[1] * fps))
