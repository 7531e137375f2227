"""loop_host_ms (ms): host milliseconds in the program's ``backend.loop``
spans (loop closure: the keyframe's insert and the find's launch, the
find's readback, verification and the pose graph) per window tick, over
the untraced ticks of a traced run.

Importing this reader turns the program's tracer on; only a traced run
imports it (``benchmark.core.program_spans``)."""

from benchmark.core import program_spans

program_spans.turn_on()


def read(run):
    return program_spans.mean([t.ms("backend.loop") for t in program_spans.window_ticks(run)])
