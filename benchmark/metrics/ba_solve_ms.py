"""ba_solve_ms (ms): median host milliseconds of the program's
``backend.ba`` spans (``TrackBA.run`` at a keyframe) in which the solver
ran (``solved``), inside the untraced ticks of a traced run.

Importing this reader turns the program's tracer on; only a traced run
imports it (``benchmark.core.program_spans``)."""

from benchmark.core import program_spans

program_spans.turn_on()


def read(run):
    return program_spans.median([s.ms for t in program_spans.window_ticks(run)
                                 for s in t.named("backend.ba") if s.attrs.get("solved")])
