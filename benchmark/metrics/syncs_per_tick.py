"""syncs_per_tick (syncs/tick): the program's synchronizing calls per window
tick (its tracer's ``sync`` counter: CUDA's sync-debug warnings on blocking
copies and readbacks, charged to the innermost open span; a CUDA event's
``synchronize`` is not one), over the untraced ticks of a traced run.

Importing this reader turns the program's tracer on; only a traced run
imports it (``benchmark.core.program_spans``)."""

from benchmark.core import program_spans

program_spans.turn_on()


def read(run):
    return program_spans.mean([t.syncs for t in program_spans.window_ticks(run)])
