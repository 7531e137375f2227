"""tick_graph_replay_pct (%): the window ticks whose ``tracker.front`` and
``tracker.back`` spans both say ``graph="replay"`` (the tick's segments
around its PnP solve replayed their captured CUDA graphs, rather than
capturing them or running eagerly), over the untraced ticks of a traced
run. A program whose tick carries no such span, or no ``graph`` on it,
reads nothing.

Importing this reader turns the program's tracer on; only a traced run
imports it (``benchmark.core.program_spans``)."""

from benchmark.core import program_spans

program_spans.turn_on()

SEGMENTS = ("tracker.front", "tracker.back")


def read(run):
    ticks = program_spans.window_ticks(run)
    modes = [{name: [s.attrs.get("graph") for s in t.named(name)] for name in SEGMENTS} for t in ticks]
    if not any(m is not None for tick in modes for seg in tick.values() for m in seg):
        return None
    replayed = sum(all(seg and all(m == "replay" for m in seg) for seg in tick.values()) for tick in modes)
    return 100.0 * replayed / len(ticks)
