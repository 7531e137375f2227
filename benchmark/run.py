"""Run one cell of the benchmark of ``thor_slam_tpu_torch`` on the card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. One cell runs once per process: set-up (the
configuration's rig renders the replay on the device, the system is built
and warmed up), the measured window of ``--seconds``, the drain, then the check of
what the window produced against the plain reference. The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics untraced, its
per-layer metrics with ``--trace 1``), ``device``, ``breakdown`` (traced)
and, last, ``checks``: each number compared with its limit, also the last
lines of standard error.

Exits 2 without a CUDA device (or fewer than the cell asks for), 3 when a
module of JAX or of the JAX package was loaded, printing no result; never
falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_T0 = time.monotonic()

FORBIDDEN = ("jax", "jaxlib", "flax", "thor_slam_tpu")


def process_age() -> float:
    """Seconds since this process started (the kernel's start time, 10 ms
    resolution), or since this module was loaded where /proc is absent."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return time.monotonic() - _T0


def forbidden_modules() -> list[str]:
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def run_cell(cell: dict, cfg: dict, mix: dict, limits: dict, bench: dict, seed: int, seconds: float, trace: bool,
             device, log=print, control=None) -> dict:
    """Set up, measure, check; returns the result object (without printing).

    ``device`` may be the CPU here (the benchmark's own tests drive a run
    at a small size); the command line refuses it. ``control`` (a dtype
    below float32, for the benchmark's tests only) judges the reference
    computed in that precision in the program's place, beside the
    program's own check (``control_checks``, ``control_correct``).
    """
    import torch

    from benchmark.core import check, spec
    from benchmark.core.driver import Driver, Run
    from benchmark.core.system import build
    from benchmark.core.trace import Profiler
    from benchmark.core.traffic import payload_stats

    entries = spec.metrics_for(cell["name"], bench, trace)
    readers = {m["name"]: spec.reader(m["name"]) for m in entries}
    cuda = device.type == "cuda"
    system = build(cfg, mix, seed, device)
    run = Run(cell=cell["name"], config=cfg, traffic=mix, seed=seed, trace=trace, device=device,
              device_name=torch.cuda.get_device_name(device) if cuda else "cpu")
    prof = Profiler(readers, cuda) if trace else None
    driver = Driver(system, run, prof)
    try:
        driver.warm_up()
        driver.window(seconds, on_start=lambda: setattr(run, "setup_s", process_age()))
    finally:
        if prof is not None:
            prof.bytes.restore()
    if cuda:
        torch.cuda.synchronize(device)
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    if prof is not None:
        prof.finish()
        run.summary, run.launch_bytes = prof.summary, prof.bytes.log
    metrics = {}
    for m in entries:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    mixed = payload_stats(run.upload_after, run.upload_before)
    log(f"window {run.window_s:.3f} s: {len(run.calls)} ticks ({mixed['full']} full, {mixed['light']} light, "
        f"{mixed['light_half']} half-res), {len(run.poses)} poses, {sum(c['keyframe'] for c in run.calls)} "
        f"keyframes among them, {len(run.rgbd_spans)} RGB-D frames, {sum(i['window'] for i in run.integrations)} "
        f"map frames, set-up {run.setup_s:.3f} s")

    # The check, once the peak is read: the engine's state is freed first,
    # the outputs judged (poses, sampled depth, the map) kept.
    prog = check.program_outputs(run, system)
    system.engine.shutdown()
    system.engine = system.rgbd = None
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref = check.reference_outputs(run, system)
    nums = check.compare(prog, ref)
    correct, checks = check.judge(nums, limits)
    log("readings not compared: " + ", ".join(f"{k} {v!r}" for k, v in nums.items() if k not in limits))
    log(f"check took {time.perf_counter() - t_check:.3f} s")

    dev = {"platform": "gpu" if cuda else "cpu", "kind": run.device_name, "count": int(cell["chips"]),
           "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": bool(correct), "attempted": len(run.calls), "failed": run.failed, "metrics": metrics,
              "device": dev}
    if run.summary is not None:
        dev["busy_s"], dev["window_s"] = run.summary.busy_s, run.summary.window_s
        result["breakdown"] = {"device_ops": run.summary.top_ops(10), "idle_gaps": run.summary.idle_gaps[:10]}
    if control is not None:
        ctrl = check.compare(check.control_outputs(run, system, control), ref)
        result["control_correct"], result["control_checks"] = check.judge(ctrl, limits)
        result["readings"], result["control_readings"] = nums, ctrl
    result["checks"] = checks
    return result


def _power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # Before numpy or torch loads: one process with few threads (the host's
    # BLAS and OpenMP pools would otherwise contend with the engine's own
    # threads from run to run), and no JAX pulled in by a library.
    os.environ.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    os.environ.setdefault("USE_FLAX", "0")

    def log(msg):
        print(f"benchmark: {msg}", file=sys.stderr, flush=True)

    from benchmark.core import spec

    bench = spec.load_benchmark()
    cell = spec.cell(args.workload, bench)
    cfg, mix, limits = spec.config(cell["config"], bench), spec.traffic(cell["traffic"]), spec.limits(cell["name"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"needs {cell['chips']} CUDA device(s); {torch.cuda.device_count()} visible")
        return 2
    try:
        import thor_slam_tpu_torch  # noqa: F401
    except ImportError as exc:
        log(f"the program is missing: {exc}")
        return 2
    device = torch.device("cuda", 0)
    log(f"{args.workload} seed {args.seed} on {_power_limit()}")
    result = run_cell(cell, cfg, mix, limits, bench, args.seed, args.seconds, bool(args.trace), device, log)
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or of the JAX package were loaded: {found}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
