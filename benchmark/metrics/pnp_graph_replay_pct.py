"""pnp_graph_replay_pct (%): the window ticks whose ``tracker.pnp`` span
says ``graph="replay"`` (the tick's RANSAC PnP replayed its captured CUDA
graph, rather than capturing one or running eagerly), over the untraced
ticks of a traced run. A program whose spans carry no ``graph`` attribute
reads nothing.

Importing this reader turns the program's tracer on; only a traced run
imports it (``benchmark.core.program_spans``)."""

from benchmark.core import program_spans

program_spans.turn_on()


def read(run):
    ticks = program_spans.window_ticks(run)
    modes = [[s.attrs.get("graph") for s in t.named("tracker.pnp")] for t in ticks]
    if not any(m is not None for tick in modes for m in tick):
        return None
    return 100.0 * sum("replay" in tick for tick in modes) / len(ticks)
