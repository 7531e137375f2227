"""keyframe_host_ms (ms): mean host milliseconds of the program's
``tracker.keyframe`` span (the keyframe front end and ``mint_bank``) per
keyframe tick, over the untraced ticks of a traced run that hold one.

Importing this reader turns the program's tracer on; only a traced run
imports it (``benchmark.core.program_spans``)."""

from benchmark.core import program_spans

program_spans.turn_on()


def read(run):
    ticks = program_spans.window_ticks(run)
    return program_spans.mean([t.ms("tracker.keyframe") for t in ticks if t.named("tracker.keyframe")])
