"""imu_predict_ms (ms): mean host milliseconds per window tick in the
program's ``engine.imu`` span (the IMU batch's ingest and the pose
prediction, inside ``engine.dispatch``), over the untraced ticks of a
traced run. A program without the span reads nothing.

Importing this reader turns the program's tracer on; only a traced run
imports it (``benchmark.core.program_spans``)."""

from benchmark.core import program_spans

program_spans.turn_on()


def read(run):
    ticks = program_spans.window_ticks(run)
    if not any(t.named("engine.imu") for t in ticks):
        return None
    return program_spans.mean([t.ms("engine.imu") for t in ticks])
