"""ba_graph_replay_pct (%): the ``backend.ba`` spans in which the solver
ran (``solved``) whose ``graph`` says ``"replay"`` (the window's solve
replayed its captured CUDA graph, rather than capturing one or running
eagerly), over those spans of the untraced ticks of a traced run. A
program whose spans carry no ``graph`` attribute, or a window with no
solve, reads nothing.

Importing this reader turns the program's tracer on; only a traced run
imports it (``benchmark.core.program_spans``)."""

from benchmark.core import program_spans

program_spans.turn_on()


def read(run):
    modes = [s.attrs.get("graph") for t in program_spans.window_ticks(run)
             for s in t.named("backend.ba") if s.attrs.get("solved")]
    if not any(m is not None for m in modes):
        return None
    return 100.0 * sum(m == "replay" for m in modes) / len(modes)
