"""tick_dispatch_ms (ms): mean host milliseconds per window tick in the
program's ``engine.dispatch`` span (relocalization, the IMU prediction,
``track_step`` and the start of its outputs' copies), over the untraced
ticks of a traced run.

Importing this reader turns the program's tracer on; only a traced run
imports it (``benchmark.core.program_spans``)."""

from benchmark.core import program_spans

program_spans.turn_on()


def read(run):
    return program_spans.mean([t.ms("engine.dispatch") for t in program_spans.window_ticks(run)])
