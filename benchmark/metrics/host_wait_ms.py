"""host_wait_ms (ms): mean milliseconds per window tick the host spent in
the program's ``wait`` spans (``engine.upload_wait``, ``engine.fetch_wait``,
``tracker.refresh_readback``: blocked on the device or the uploader's
thread), over the untraced ticks of a traced run.

Importing this reader turns the program's tracer on; only a traced run
imports it (``benchmark.core.program_spans``)."""

from benchmark.core import program_spans

program_spans.turn_on()


def read(run):
    return program_spans.mean([t.wait_ms() for t in program_spans.window_ticks(run)])
