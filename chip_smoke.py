#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

0. requires a CUDA device, prints the card's name and power limit and pins
   full-f32 precision;
1. builds the kernels from ``thor_slam_tpu_torch/csrc`` and prints the
   build time and the compiler's per-kernel resource report;
2. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (patch gather exactly, FAST-9 within 1e-6, the SGM
   scan and the winner/LR pass exactly, also at the 720p geometry) and
   times both with CUDA events (median of 20 launches after warm-up);
3. drives ``TorchSlamEngine`` over 40 ticks of the synthetic flagship rig
   (4 stereo cameras at 640x400, 512 keypoints per camera, a 1280x800
   color imager on each), times ``process_frames``, and checks tracking,
   ATE against ground truth and that the tick launched both tracking
   kernels and never their plain versions;
4. on every 5th tick, as ``scripts/run_pipeline.py`` does, produces the
   RGB-D frame of the first camera (``RGBDProcessor``, color mode, D = 64,
   depth aligned to the 1280x800 color image), times it, checks its depth
   against the renderer's ground truth and that it launched both SGM
   kernels and never their plain versions; then splits one more frame
   into synchronized phases.

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
RGBD_EVERY = 5  # run_pipeline's --rgbd-every
RGBD_DISPARITIES = 64  # RGBDProcessor's default
COLOR_RESOLUTION = (1280, 800)  # config/slam_config.yaml rgb_output_resolution
# Depth accuracy bar on pixels with ground truth in (0.2, 8) m: the bar of
# tests/test_pipeline.py (median relative error < 0.05, valid share > 0.3).
MAX_MEDIAN_REL_ERR = 0.05
MIN_VALID_SHARE = 0.3
P1, P2 = 6.0, 96.0  # sgm_disparity's default penalties


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


def check_sgm_scan(sgm_cuda, dev) -> dict:
    """Scan kernel vs plain, bit-exact, on random integral costs in [0, 32]."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
    d, h, w = RGBD_DISPARITIES, 400, 640
    # The main path's layout: step-major views of one (H, W, D) volume.
    cost_hwd = torch.randint(0, 33, (h, w, d), generator=gen).float().to(dev)
    add_hwd = torch.randint(0, 129, (h, w, d), generator=gen).float().to(dev)
    views = {"horizontal": (1, 2, 0), "vertical": (0, 2, 1)}  # (W, D, H) and (H, D, W)
    main_path = None
    for name, perm in views.items():
        cost, add = cost_hwd.permute(*perm), add_hwd.permute(*perm)
        for reverse in (False, True):
            for add_to in (None, add):
                got = sgm_cuda.sgm_aggregate_dir_cuda(cost, P1, P2, reverse, add_to)
                want = sgm_cuda.sgm_aggregate_dir_plain(cost, P1, P2, reverse, add_to)
                torch.cuda.synchronize()
                exact = torch.equal(got, want)
                err = float((got - want).abs().max())
                ms = time_cuda(lambda: sgm_cuda.sgm_aggregate_dir_cuda(cost, P1, P2, reverse, add_to))
                plain_ms = time_cuda(lambda: sgm_cuda.sgm_aggregate_dir_plain(cost, P1, P2, reverse, add_to), reps=5)
                print(
                    f"sgm_scan {name} S,D,X={','.join(map(str, cost.shape))} reverse={reverse} "
                    f"add={add_to is not None}: exact={exact} max_abs_err={err} "
                    f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms (plain over 5 reps)"
                )
                if not exact:
                    raise AssertionError(f"SGM scan differs from its plain version ({name}, reverse={reverse})")
                if name == "horizontal" and not reverse and add_to is None:
                    main_path = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    for (d, h, w), plain_reps in (((64, 400, 640), 5), ((96, 720, 1280), 3)):
        cost = torch.randint(0, 33, (d, h, w), generator=gen).float().to(dev)
        got = sgm_cuda.sgm_aggregate_4dir_cuda(cost, P1, P2)
        want = sgm_cuda.sgm_aggregate_4dir_plain(cost, P1, P2)
        torch.cuda.synchronize()
        exact = torch.equal(got, want)
        ms = time_cuda(lambda: sgm_cuda.sgm_aggregate_4dir_cuda(cost, P1, P2))
        plain_ms = time_cuda(lambda: sgm_cuda.sgm_aggregate_4dir_plain(cost, P1, P2), reps=plain_reps, warmup=1)
        print(
            f"sgm_aggregate_4dir D,H,W={d},{h},{w}: exact={exact} max_abs_err={float((got - want).abs().max())} "
            f"kernel path {ms:.4f} ms  plain {plain_ms:.4f} ms (plain over {plain_reps} reps)"
        )
        if not exact:
            raise AssertionError(f"4-direction aggregation differs from its plain version at {(d, h, w)}")
        del cost, got, want
    return main_path


def check_winner(sgm_cuda, dev) -> dict:
    """Winner/LR kernel vs plain, exact, on a tie-heavy integer volume."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 3)
    main_path = None
    for d, h, w in ((64, 400, 640), (64, 400, 600), (96, 720, 1280)):
        agg = torch.randint(0, 400, (d, h, w), generator=gen).float().to(dev)
        got = sgm_cuda.winner_lr_cuda(agg, d)
        want = sgm_cuda.winner_lr_plain(agg, d)
        torch.cuda.synchronize()
        exact = all(torch.equal(g, x) for g, x in zip(got, want))
        err = max(float((g.float() - x.float()).abs().max()) for g, x in zip(got, want))
        ms = time_cuda(lambda: sgm_cuda.winner_lr_cuda(agg, d))
        plain_ms = time_cuda(lambda: sgm_cuda.winner_lr_plain(agg, d))
        print(
            f"sgm_winner_lr D,H,W={d},{h},{w}: exact={exact} max_abs_err={err} "
            f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
        )
        if not exact:
            raise AssertionError(f"winner/LR kernel differs from its plain version at {(d, h, w)}")
        if (d, h, w) == (64, 400, 640):
            main_path = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return main_path


def depth_accuracy(frame, gt: np.ndarray) -> tuple[float, float]:
    """(valid share, median relative error) on pixels with truth in (0.2, 8) m."""
    est = frame.depth_mm.astype(np.float64) / 1000.0
    valid = (est > 0) & (gt > 0.2) & (gt < 8.0)
    rel = np.abs(est[valid] - gt[valid]) / gt[valid]
    return float(valid.mean()), float(np.median(rel)) if valid.any() else float("inf")


def rgbd_phases(processor, sync, color) -> dict:
    """One RGB-D frame split into phases, the device synchronized around each."""
    from thor_slam_tpu_torch.ops import sgm_cuda, stereo
    from thor_slam_tpu_torch.ops.image import remap_bilinear

    frames = sync.get_frames_for_source(processor.camera_name)
    ms = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t)
        return out

    sr = processor.rectification
    left_raw, right_raw, color_img = timed("upload", lambda: (
        processor.upload(frames[0].image), processor.upload(frames[1].image),
        torch.from_numpy(color.image).to(processor.device),
    ))
    m = processor.maps
    left, right = timed("rectify", lambda: (
        remap_bilinear(left_raw, m[0], m[1]), remap_bilinear(right_raw, m[2], m[3])
    ))
    cost = timed("census + cost", lambda: stereo.census_cost_volume(
        *stereo.census_transform(torch.stack([left, right])), RGBD_DISPARITIES
    ))
    agg = timed("aggregate (4 scans)", lambda: sgm_cuda.sgm_aggregate_4dir(cost, P1, P2))
    winners = timed("winner/LR", lambda: sgm_cuda.winner_lr(agg, RGBD_DISPARITIES))
    depth = timed("tail + depth", lambda: stereo.disparity_to_depth(
        *stereo.disparity_from_winners(*winners, RGBD_DISPARITIES), sr.fx, sr.baseline_m
    ))
    aligned = timed("align to color", lambda: processor.align(depth))
    depth_mm = timed("u16 encode", lambda: stereo.depth_to_millimeters_u16(aligned))
    timed("fetch", lambda: (color_img.cpu().numpy(), depth_mm.cpu().numpy()))
    return ms


def run_slice(dev) -> dict:
    from thor_slam_tpu.camera.rig import CameraRig
    from thor_slam_tpu.slam.interface import SlamConfig, TrackingState
    from thor_slam_tpu.utils.evaluation import ate_rmse
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
    from thor_slam_tpu_torch.ops import fast_cuda, patches_cuda, sgm_cuda
    from thor_slam_tpu_torch.pipeline import RGBDProcessor
    from thor_slam_tpu_torch.utils.flagship import flagship_rig

    torch.cuda.reset_peak_memory_stats()
    params, _, calibration, sources, _, traj = flagship_rig(4, 640, 400, 512, color_resolution=COLOR_RESOLUTION)
    src = sources[0]
    t0 = time.perf_counter()
    frames, colors = [], {}
    with CameraRig(sources, rig_extrinsics=calibration.rig_extrinsics) as rig:
        for i in range(TICKS + 1):
            frames.append(rig.get_synchronized_frames())
            if (i + 1) % RGBD_EVERY == 0 or i == TICKS:
                colors[i] = src.try_get_latest_rgb_frame()
    truth = {i: src.render_color_depth(c.sequence_num) for i, c in colors.items()}
    extra = frames.pop()  # the frame set of the phase split
    print(
        f"rendered {TICKS + 1} frame sets (4 x 2 x 640x400), {len(colors)} color frames and their depth "
        f"({COLOR_RESOLUTION[0]}x{COLOR_RESOLUTION[1]}) in {time.perf_counter() - t0:.1f} s"
    )
    processor = RGBDProcessor(
        src.name, src.get_intrinsics(), src.get_extrinsics(), num_disparities=RGBD_DISPARITIES,
        color_intrinsics=src.get_rgb_intrinsics(), left_t_color=src.get_rgb_extrinsics().to_4x4_matrix(),
        device=dev,
    )
    processor.process(extra, color_frame=colors[TICKS])  # warm-up

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
    sgm_cuda.reset_counts()
    tick_ms, refreshed, states, est, gt = [], [], [], [], []
    rgbd_ms, rgbd_acc = [], []
    gt0 = traj.pose(frames[0].timestamp)
    for i, fs in enumerate(frames):
        t = time.perf_counter()
        pose = engine.process_frames(fs)
        torch.cuda.synchronize()
        tick_ms.append(1e3 * (time.perf_counter() - t))
        refreshed.append(engine.last_diagnostics["refreshed"])
        states.append(engine.get_tracking_state())
        if pose is not None:
            est.append(pose.position.copy())
            gt.append((np.linalg.inv(gt0) @ traj.pose(fs.timestamp))[:3, 3])
        if (i + 1) % RGBD_EVERY == 0:
            t = time.perf_counter()
            frame = processor.process(fs, color_frame=colors[i], fetch=True)
            rgbd_ms.append(1e3 * (time.perf_counter() - t))
            if frame.depth_mm.shape != COLOR_RESOLUTION[::-1] or frame.rgb.shape != (*COLOR_RESOLUTION[::-1], 3):
                raise AssertionError(f"RGB-D frame shapes {frame.rgb.shape} / {frame.depth_mm.shape}")
            rgbd_acc.append((i, *depth_accuracy(frame, truth[i])))
    counts = {
        "patch_gather": dict(patches_cuda.counts),
        "fast9_nms": dict(fast_cuda.counts),
        **{name: dict(c) for name, c in sgm_cuda.counts.items()},
    }
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
    shares = [a[1] for a in rgbd_acc]
    rels = [a[2] for a in rgbd_acc]
    print(
        f"rgbd: {len(rgbd_ms)} frames (640x400 stereo, D={RGBD_DISPARITIES}, color "
        f"{COLOR_RESOLUTION[0]}x{COLOR_RESOLUTION[1]}, fetch=True): median ms/frame {statistics.median(rgbd_ms):.3f} "
        f"(min {min(rgbd_ms):.3f}, max {max(rgbd_ms):.3f})"
    )
    print(
        f"rgbd: valid share median {statistics.median(shares):.4f} (min {min(shares):.4f}); median relative "
        f"depth error median {statistics.median(rels):.5f} (max {max(rels):.5f}); bar < {MAX_MEDIAN_REL_ERR}, "
        f"valid > {MIN_VALID_SHARE}"
    )
    print("rgbd: per frame (tick, valid share, median rel err): " + ", ".join(
        f"({i}, {v:.4f}, {r:.5f})" for i, v, r in rgbd_acc
    ))
    phases = rgbd_phases(processor, extra, colors[TICKS])
    print(
        "rgbd phases (ms, synchronized, one frame): "
        + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
        + f"; sum {sum(phases.values()):.3f}"
    )

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
    rgbd_frames = TICKS // RGBD_EVERY
    if len(rgbd_ms) != rgbd_frames:
        raise AssertionError(f"{len(rgbd_ms)} RGB-D frames, expected {rgbd_frames}")
    if counts["sgm_scan"]["kernel"] < 4 * rgbd_frames:
        raise AssertionError(f"SGM scan launched {counts['sgm_scan']['kernel']} < 4 x {rgbd_frames}")
    if counts["sgm_winner_lr"]["kernel"] < rgbd_frames:
        raise AssertionError(f"winner/LR launched {counts['sgm_winner_lr']['kernel']} < {rgbd_frames}")
    if any(c["plain"] for c in counts.values()):
        raise AssertionError(f"plain versions ran on the main path: {counts}")
    if not max(rels) < MAX_MEDIAN_REL_ERR or not min(shares) > MIN_VALID_SHARE:
        raise AssertionError(f"RGB-D depth off the bar: valid shares {shares}, median rel errors {rels}")
    return {name: c["kernel"] for name, c in counts.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from thor_slam_tpu_torch.ops import fast_cuda, patches_cuda, sgm_cuda
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
    scan = check_sgm_scan(sgm_cuda, dev)
    winner = check_winner(sgm_cuda, dev)
    torch.cuda.empty_cache()
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
            {
                "name": "sgm_scan",
                "route": "cuda",
                "source": "thor_slam_tpu_torch/csrc/sgm.cu",
                "replaces": "thor_slam_tpu/ops/sgm_pallas.py:61",
                "launches": launches["sgm_scan"],
                **scan,
            },
            {
                "name": "sgm_winner_lr",
                "route": "cuda",
                "source": "thor_slam_tpu_torch/csrc/sgm.cu",
                "replaces": "thor_slam_tpu/ops/sgm_pallas.py:249",
                "launches": launches["sgm_winner_lr"],
                **winner,
            },
        ]
    }
    print(json.dumps(record))
    device = {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
