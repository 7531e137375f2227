"""posegraph_solve_ms (ms): mean host milliseconds of the program's
``loop.posegraph`` spans (a loop closure's pose-graph solve, its result's
readback included) inside the untraced ticks of a traced run. A window
with no solve, or a program without the span, reads nothing.

Importing this reader turns the program's tracer on; only a traced run
imports it (``benchmark.core.program_spans``)."""

from benchmark.core import program_spans

program_spans.turn_on()


def read(run):
    return program_spans.mean([s.ms for t in program_spans.window_ticks(run) for s in t.named("loop.posegraph")])
