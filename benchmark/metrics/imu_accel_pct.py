"""imu_accel_pct (%): the window ticks whose ``engine.imu`` span says
``accel`` (the pose prediction took the accelerometer path: the gravity
estimate has converged in the IMU's own frame), over the untraced ticks of
a traced run. A program without the span reads nothing.

Importing this reader turns the program's tracer on; only a traced run
imports it (``benchmark.core.program_spans``)."""

from benchmark.core import program_spans

program_spans.turn_on()


def read(run):
    ticks = program_spans.window_ticks(run)
    spans = [t.named("engine.imu") for t in ticks]
    if not any(spans):
        return None
    return 100.0 * sum(any(s.attrs.get("accel") for s in tick) for tick in spans) / len(ticks)
