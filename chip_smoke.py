#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

0. requires a CUDA device, prints the card's name and power limit and pins
   full-f32 precision;
1. builds the kernels from ``thor_slam_tpu_torch/csrc`` and prints the
   build time and the compiler's per-kernel resource report;
2. holds each kernel against its plain PyTorch version on the card at the
   tracker's shapes (patch gather exactly, FAST-9 within 1e-6) and times
   both with CUDA events (median of 20 launches after warm-up);
3. drives ``TorchSlamEngine`` over 40 ticks of the synthetic flagship rig
   (4 stereo cameras at 640x400, 512 keypoints per camera), times
   ``process_frames``, and checks tracking, ATE against ground truth and
   that the tick launched both kernels and never their plain versions.

Any failure exits non-zero without printing a result. The last line is
``{"ok": true, "device": {...}}``; the line before it is the per-kernel
JSON record. Imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
TICKS = 40
WARMUP_TICKS = 3
SEED = 0


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def time_cuda(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_patch_gather(patches_cuda, dev) -> dict:
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    main_path = None
    for (c, h, w), size in (((4, 400, 640), 19), ((4, 200, 320), 19), ((4, 400, 640), 37)):
        m = 2048
        images = torch.rand((c, h, w), generator=gen).to(dev)
        cam = torch.arange(c, dtype=torch.int32).repeat_interleave(m // c).to(dev)
        # Centres spill 30 px past every border, so many windows are clipped.
        cx = torch.randint(-30, w + 30, (m,), generator=gen, dtype=torch.int32)
        cy = torch.randint(-30, h + 30, (m,), generator=gen, dtype=torch.int32)
        centers = torch.stack([cx, cy], -1).to(dev)
        got = patches_cuda.extract_patches_flat_cuda(images, cam, centers, size)
        want = patches_cuda.extract_patches_flat_plain(images, cam, centers, size)
        torch.cuda.synchronize()
        exact = torch.equal(got, want)
        err = float((got - want).abs().max())
        ms = time_cuda(lambda: patches_cuda.extract_patches_flat_cuda(images, cam, centers, size))
        plain_ms = time_cuda(lambda: patches_cuda.extract_patches_flat_plain(images, cam, centers, size))
        print(
            f"patch_gather C,H,W={c},{h},{w} S={size} M={m}: exact={exact} max_abs_err={err} "
            f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
        )
        if not exact:
            raise AssertionError(f"patch gather differs from its plain version at {(c, h, w)}, S={size}")
        if (c, h, w, size) == (4, 400, 640, 19):
            main_path = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return main_path


def check_fast(fast_cuda, dev) -> dict:
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    main_path = None
    for shape in ((4, 400, 640), (4, 720, 1280)):
        images = torch.rand(shape, generator=gen).to(dev)
        raw_k, nms_k = fast_cuda.fast_scores_cuda(images, 0.05)
        raw_p, nms_p = fast_cuda.fast_scores_plain(images, 0.05)
        torch.cuda.synchronize()
        err = max(float((raw_k - raw_p).abs().max()), float((nms_k - nms_p).abs().max()))
        corners = int((nms_k > 0).sum())
        ms = time_cuda(lambda: fast_cuda.fast_scores_cuda(images, 0.05))
        plain_ms = time_cuda(lambda: fast_cuda.fast_scores_plain(images, 0.05))
        print(
            f"fast9_nms C,H,W={','.join(map(str, shape))}: max_abs_err={err} nms_peaks={corners} "
            f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
        )
        if not err <= 1e-6:
            raise AssertionError(f"FAST kernel differs from its plain version by {err} at {shape}")
        if shape == (4, 400, 640):
            main_path = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return main_path


def run_slice(dev) -> dict:
    from thor_slam_tpu.camera.rig import CameraRig
    from thor_slam_tpu.slam.interface import SlamConfig, TrackingState
    from thor_slam_tpu.utils.evaluation import ate_rmse
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
    from thor_slam_tpu_torch.ops import fast_cuda, patches_cuda
    from thor_slam_tpu_torch.utils.flagship import flagship_rig

    params, _, calibration, sources, _, traj = flagship_rig(4, 640, 400, 512)
    t0 = time.perf_counter()
    with CameraRig(sources, rig_extrinsics=calibration.rig_extrinsics) as rig:
        frames = [rig.get_synchronized_frames() for _ in range(TICKS)]
    print(f"rendered {TICKS} frame sets (4 x 2 x 640x400) in {time.perf_counter() - t0:.1f} s")

    config = SlamConfig(num_cameras=8, enable_loop_closure=False)
    overrides = dict(max_keypoints=params.max_keypoints)
    warm = TorchSlamEngine(params=overrides, device=dev, seed=SEED)
    warm.initialize(calibration, config)
    for fs in frames[:WARMUP_TICKS]:
        warm.process_frames(fs)
    warm.shutdown()

    engine = TorchSlamEngine(params=overrides, device=dev, seed=SEED)
    engine.initialize(calibration, config)
    torch.cuda.synchronize()
    patches_cuda.reset_counts()
    fast_cuda.reset_counts()
    tick_ms, refreshed, states, est, gt = [], [], [], [], []
    gt0 = traj.pose(frames[0].timestamp)
    for fs in frames:
        t = time.perf_counter()
        pose = engine.process_frames(fs)
        torch.cuda.synchronize()
        tick_ms.append(1e3 * (time.perf_counter() - t))
        refreshed.append(engine.last_diagnostics["refreshed"])
        states.append(engine.get_tracking_state())
        if pose is not None:
            est.append(pose.position.copy())
            gt.append((np.linalg.inv(gt0) @ traj.pose(fs.timestamp))[:3, 3])
    counts = {"patch_gather": dict(patches_cuda.counts), "fast9_nms": dict(fast_cuda.counts)}
    inliers = engine.last_diagnostics["num_inliers"]
    keyframes = int(sum(refreshed))
    ate = ate_rmse(np.asarray(est), np.asarray(gt))
    kf_ms = [t for t, r in zip(tick_ms, refreshed) if r]
    hot_ms = [t for t, r in zip(tick_ms, refreshed) if not r]
    print(
        f"slice: {TICKS} ticks, median ms/tick {statistics.median(tick_ms):.3f} | keyframe "
        f"{statistics.median(kf_ms):.3f} (n={len(kf_ms)}) | non-keyframe "
        f"{statistics.median(hot_ms):.3f} (n={len(hot_ms)}) | first tick {tick_ms[0]:.1f}"
    )
    print(f"slice: inliers at last tick {inliers}, keyframes {keyframes}, ATE {ate * 100:.3f} cm")
    print(f"slice: launch counts {json.dumps(counts)}")
    print(f"slice: peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    first = next((i for i, s in enumerate(states) if s == TrackingState.TRACKING), None)
    if first is None or first > 3:
        raise AssertionError(f"not TRACKING by tick 3 (first at {first})")
    held = np.mean([s == TrackingState.TRACKING for s in states[first:]])
    if held < 0.9:
        raise AssertionError(f"TRACKING held on only {held:.0%} of ticks after tick {first}")
    if not ate < 0.05:
        raise AssertionError(f"ATE {ate:.4f} m >= 0.05 m")
    if counts["patch_gather"]["kernel"] < 4 * TICKS:
        raise AssertionError(f"patch gather launched {counts['patch_gather']['kernel']} < 4 x {TICKS}")
    if counts["fast9_nms"]["kernel"] < 2 * keyframes or keyframes == 0:
        raise AssertionError(f"FAST launched {counts['fast9_nms']['kernel']} for {keyframes} keyframes")
    if counts["patch_gather"]["plain"] or counts["fast9_nms"]["plain"]:
        raise AssertionError(f"plain versions ran on the main path: {counts}")
    return {name: c["kernel"] for name, c in counts.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from thor_slam_tpu_torch.ops import fast_cuda, patches_cuda
    from thor_slam_tpu_torch.utils import cuda_lib
    from thor_slam_tpu_torch.utils.platform import pin_precision

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    print(nvidia_smi_line())
    pin_precision()

    t0 = time.perf_counter()
    cuda_lib.build()
    cuda_lib.load()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for line in cuda_lib.build_log.splitlines():
        if "Function properties" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    patch = check_patch_gather(patches_cuda, dev)
    fast = check_fast(fast_cuda, dev)
    launches = run_slice(dev)

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    record = {
        "kernels": [
            {
                "name": "patch_gather",
                "route": "cuda",
                "source": "thor_slam_tpu_torch/csrc/patches.cu",
                "replaces": "thor_slam_tpu/ops/patches_pallas.py:68",
                "launches": launches["patch_gather"],
                **patch,
            },
            {
                "name": "fast9_nms",
                "route": "cuda",
                "source": "thor_slam_tpu_torch/csrc/fast.cu",
                "replaces": "thor_slam_tpu/ops/fast_pallas.py:98",
                "launches": launches["fast9_nms"],
                **fast,
            },
        ]
    }
    print(json.dumps(record))
    device = {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
