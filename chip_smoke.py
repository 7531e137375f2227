#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. With
``--kernels-only`` it runs phases 0-2 alone and prints their numbers, no
result line: a kernel PR copies the script into a ``git archive`` of its
parent and runs parent, change, change, parent in one call, so both
versions' kernels are checked and timed by the same code. With
``--fast-phases`` it also times the FAST kernel built with one phase left
out at a time, which shows where its time goes. It

0. requires a CUDA device, prints the card's name and power limit and pins
   full-f32 precision;
1. builds the kernels from ``thor_slam_tpu_torch/csrc`` and prints the
   build time and the compiler's per-kernel resource report;
2. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (patch gather exactly: the single-stack entry and
   the pair entry, which gathers from two stacks in one launch and clips
   the centres, also on ragged shapes, M = 1 and strided stacks; FAST-9
   within 1e-6 at 4 and 8 images of 400x640, 720p, ragged shapes and a
   rendered frame set; the SGM
   scan, every direction and the 4-direction path, and the winner/LR pass
   exactly at D in {48, 64, 96, 256} on ragged H, W, H = 1, W < D, the
   flagship and the 720p geometry, for integral and non-integral
   penalties) and measures each kernel at the main path's shapes: its
   device time (20 calls captured in a CUDA graph, replayed between two
   events), its call time (CUDA events around one call, the host's side
   included), the plain version's, the one PyTorch call that computes the
   same function where there is one (the gather: ``images[cam, ys, xs]``),
   and its bound (bytes over 3.35 TB/s). The gather's row is the pair
   launch of a KLT level (with one and two single-stack launches beside
   it), FAST's the 8-image launch of the stereo pair (with the 4-image
   launch and the rendered frame set beside it). A module without a pair
   entry (a parent tree under ``--kernels-only``) is timed by its
   single-stack launches alone;
3. drives ``TorchSlamEngine`` over 40 ticks of the synthetic flagship rig
   (4 stereo cameras at 640x400, 512 keypoints per camera, a 1280x800
   color imager on each), times ``process_frames``, and checks tracking,
   ATE against ground truth and that the ticks launched the gather exactly
   once per KLT level and tick plus once per keyframe, FAST exactly once
   per keyframe, and never their plain versions;
4. on every 5th tick, as ``scripts/run_pipeline.py`` does, produces the
   RGB-D frame of the first camera (``RGBDProcessor``, color mode, D = 64,
   depth aligned to the 1280x800 color image), times it, checks its depth
   against the renderer's ground truth and that it launched both SGM
   kernels and never their plain versions; then splits one more frame
   into synchronized phases;
5. drives ``TorchSlamEngine`` at its defaults (bundle adjustment, IMU
   fusion with the accelerometer term, loop closure) on the same rig with
   the IMU of source 0, over a 240-tick revisit orbit at 1 rad/s with black
   frames on ticks 60-73 (session 1; keyframe spacing and loop candidates
   changed for this orbit, see FULL_PARAMS), and checks tracking, loop closure,
   BA, the gravity estimate and the map-lifted ATE; times one BA solve,
   one loop lookup, one verification and one pose-graph solve; then saves
   the map, and a fresh engine on a rig whose clocks start 1 s later loads
   it, relocalizes (through the FAST and gather kernels) and tracks 10
   ticks in its frame (session 2).

Any failure exits non-zero without printing a result. The last line is
``{"ok": true, "device": {...}}``; the line before it is the per-kernel
JSON record, with launches on the main path and per period (5 ticks: one
RGB-D frame), and each kernel's loss per period, launches x (device ms -
bound ms), by which the kernels are ranked. Imports nothing of JAX or of
the JAX package.
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
# Kernel checks: (D, H, W) at the disparity counts the port takes, with H
# and W multiples of no tile of either SGM kernel, H = 1 and W < D; then
# the flagship (D = 64, 400x640) and the 720p geometry (D = 96).
SGM_SHAPES = [(48, 37, 203), (64, 1, 50), (64, 45, 37), (96, 23, 61), (256, 9, 100), (256, 3, 300),
              (64, 400, 640), (96, 720, 1280)]
SGM_PENALTIES = [(P1, P2), (6.5, 97.25)]  # integral, non-integral
GRAPH_CALLS = 20  # calls captured in the graph a device time replays
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# Full-engine phase: a revisit orbit (tests/test_engine_loop_e2e.py scaled to
# the flagship) whose blackout makes the odometry drift.
FULL_TICKS = 240  # ~1.27 orbits at 1 rad/s and 30 fps
FULL_RATE = 1.0  # rad/s around the orbit
BLACKOUT = range(60, 74)
# Changes from the defaults, for this orbit. Keyframe spacing as in the
# loop end-to-end test (a keyframe every ~5 ticks instead of ~2.5 at
# 1.8 m/s); and only keyframes older than ~0.8 orbit are loop candidates:
# on the 4-camera rig every 90 degrees of the orbit brings another
# camera's view back, and those cross-camera verifications from ~2.5 m
# away returned poses tens of cm off (the first closed at 1.4 s, 55 cm
# off, with no drift yet to correct). The IMU ring holds 512 samples: a
# synthetic source whose clock starts 1 s late delivers that second's 400
# samples in its first packet, and a 256-sample ring would drop the ones
# the first ticks integrate (their windows came out empty, and after the
# relocalization snap the 1 rad/s rotation outran the zero-motion
# prediction).
FULL_PARAMS = dict(keyframe_max_translation=0.3, keyframe_max_rotation=0.35)
FULL_ENGINE_ARGS = dict(loop_exclude_recent=30, imu_buffer_capacity=512)
RELOC_TICKS = 10
RELOC_OFFSET_S = 1.0
MAX_RELOC_ERR_M = 0.05


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def call_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of one call of ``fn()`` between two CUDA events
    on an idle stream, over ``reps`` calls after warm-up. The window holds
    the host's side of the call (validation, allocation, the launch), so it
    is the call's time, not the kernel's."""
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


def device_ms(fn, calls: int = GRAPH_CALLS, replays: int = 5) -> float:
    """The device's own milliseconds for one call of ``fn()``: ``calls``
    calls captured in one CUDA graph, replayed between two CUDA events
    (median over ``replays``). The replay launches the captured kernels
    back to back with no host work between them, so the window holds the
    kernels' time and the graph's small per-node gaps."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as graph capture wants
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def bound_ms(nbytes: float) -> float:
    """Least time to move ``nbytes`` through device memory at the H100
    SXM's 3.35 TB/s (every kernel here is bound by bytes: it does a few
    operations per byte, far under the card's peak rates)."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def _gather_inputs(gen, shape, m, dev):
    """Two (C, H, W) stacks, a camera-major ``cam`` and (2, M, 2) centres that
    spill 30 px past every border, so many windows are clipped."""
    c, h, w = shape
    stacks = [torch.rand(shape, generator=gen).to(dev) for _ in range(2)]
    cam = torch.arange(c, dtype=torch.int32).repeat_interleave(-(-m // c))[:m].to(dev)
    cx = torch.randint(-30, w + 30, (2, m), generator=gen, dtype=torch.int32)
    cy = torch.randint(-30, h + 30, (2, m), generator=gen, dtype=torch.int32)
    return stacks, cam, torch.stack([cx, cy], -1).to(dev)


def _index_gather(images, cam, centers, size):
    """The library yardstick of one stack: the index tensors of one
    advanced-index call, built outside the timed window."""
    _, h, w = images.shape
    r = size // 2
    offs = torch.arange(-r, r + 1, device=images.device)
    xs = torch.clamp(centers[:, 0], r, w - r - 1).long()[:, None, None] + offs[None, None, :]
    ys = torch.clamp(centers[:, 1], r, h - r - 1).long()[:, None, None] + offs[None, :, None]
    return cam.long()[:, None, None], ys, xs


def check_patch_gather(patches_cuda, dev) -> dict:
    """Gather kernel vs plain, exact: the single-stack entry at the main
    path's shapes, and the pair entry (where the module has one: the script
    also times a parent tree that has none) against two plain calls, with
    its clipped centres against the tensor clamps, at those shapes and on
    ragged ones. Times one single-stack launch, two of them in a row, and
    the pair launch."""
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    has_pair = hasattr(patches_cuda, "extract_patches_pair_cuda")
    main_path = None
    # (shape, S, M): the main path's three, then M = 1, M a multiple of no
    # block's patch count, a patch as large as the image, a generic size.
    cases = [((4, 400, 640), 19, 2048), ((4, 200, 320), 19, 2048), ((4, 400, 640), 37, 2048),
             ((3, 41, 37), 9, 1), ((3, 41, 37), 19, 13), ((2, 37, 53), 37, 7), ((1, 64, 48), 5, 1001)]
    for shape, size, m in cases:
        c, h, w = shape
        stacks, cam, centers = _gather_inputs(gen, shape, m, dev)
        timed = m == 2048
        for images, ctr in zip(stacks, centers):
            got = patches_cuda.extract_patches_flat_cuda(images, cam, ctr, size)
            want = patches_cuda.extract_patches_flat_plain(images, cam, ctr, size)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"patch gather differs from its plain version at {shape}, S={size}, M={m}")
        err = float((got - want).abs().max())
        if has_pair:
            got2, clipped = patches_cuda.extract_patches_pair_cuda(*stacks, cam, centers, size)
            want2 = torch.stack([
                patches_cuda.extract_patches_flat_plain(images, cam, ctr, size) for images, ctr in zip(stacks, centers)
            ])
            r = size // 2
            clamps = torch.stack(
                [torch.clamp(centers[..., 0], r, w - r - 1), torch.clamp(centers[..., 1], r, h - r - 1)], -1
            )
            torch.cuda.synchronize()
            err = max(err, float((got2 - want2).abs().max()))
            if not torch.equal(got2, want2) or not torch.equal(clipped, clamps) or clipped.dtype != torch.int32:
                raise AssertionError(f"pair gather differs from two plain calls at {shape}, S={size}, M={m}")
            # One eye of a (C, 2, H, W) tensor, as BRIEF hands it over.
            both = torch.stack(stacks, 1)
            got3, _ = patches_cuda.extract_patches_pair_cuda(both[:, 0], both[:, 1], cam, centers, size)
            if not torch.equal(got3, want2):
                raise AssertionError(f"pair gather on strided stacks differs at {shape}, S={size}, M={m}")
        if not timed:
            print(f"patch_gather C,H,W={c},{h},{w} S={size} M={m}: exact (pair entry checked: {has_pair})")
            continue
        images, ctr = stacks[0], centers[0]
        single = lambda: patches_cuda.extract_patches_flat_cuda(images, cam, ctr, size)  # noqa: E731
        two = lambda: [patches_cuda.extract_patches_flat_cuda(i, cam, k, size) for i, k in zip(stacks, centers)]  # noqa: E731
        dev_ms, two_ms = device_ms(single), device_ms(two)
        ms = call_ms(single)
        plain_ms = call_ms(lambda: patches_cuda.extract_patches_flat_plain(images, cam, ctr, size))
        index = [_index_gather(i, cam, k, size) for i, k in zip(stacks, centers)]
        if not torch.equal(images[index[0]], got2[0] if has_pair else single()):
            raise AssertionError("the advanced-index yardstick differs from the gather")
        library_ms = device_ms(lambda: images[index[0]])
        # The patch pixels read once (windows rarely overlap), the indices, the patches written.
        nbytes = 2 * m * size * size * 4 + m * 3 * 4
        print(
            f"patch_gather C,H,W={c},{h},{w} S={size} M={m}: exact=True max_abs_err={err} device "
            f"{dev_ms:.4f} ms  two launches {two_ms:.4f} ms  call {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"images[cam, ys, xs] {library_ms:.4f} ms  bound {bound_ms(nbytes):.4f} ms ({nbytes / 1e6:.2f} MB)"
        )
        row = dict(max_abs_err=err, ms=dev_ms, call_ms=ms, plain_ms=plain_ms, bound_ms=bound_ms(nbytes),
                   bound_by="bytes", library_ms=library_ms, two_single_launches_ms=two_ms)
        if has_pair:
            pair = lambda: patches_cuda.extract_patches_pair_cuda(*stacks, cam, centers, size)  # noqa: E731
            # Both stacks' pixels and patches, cam once, the centres in and the clipped centres out.
            pair_bytes = 2 * 2 * m * size * size * 4 + m * 4 + 2 * 2 * m * 2 * 4
            pair_row = dict(
                max_abs_err=err, ms=device_ms(pair), call_ms=call_ms(pair),
                plain_ms=call_ms(lambda: patches_cuda.extract_patches_pair_plain(*stacks, cam, centers, size)),
                bound_ms=bound_ms(pair_bytes), bound_by="bytes",
                library_ms=device_ms(lambda: [s[i] for s, i in zip(stacks, index)]),
                two_single_launches_ms=two_ms, single_ms=dev_ms, single_call_ms=ms, single_bound_ms=row["bound_ms"],
                single_library_ms=library_ms,
            )
            print(
                f"patch_gather pair C,H,W=2x{c},{h},{w} S={size} M=2x{m}: device {pair_row['ms']:.4f} ms "
                f"({pair_row['ms'] / two_ms:.3f} of two single launches)  call {pair_row['call_ms']:.4f} ms  "
                f"plain {pair_row['plain_ms']:.4f} ms  two images[cam, ys, xs] {pair_row['library_ms']:.4f} ms  "
                f"bound {pair_row['bound_ms']:.4f} ms ({pair_bytes / 1e6:.2f} MB)"
            )
            row = pair_row
        if (c, h, w, size) == (4, 400, 640, 19):
            main_path = row  # the launch KLT makes at level 0: the pair where there is one
    return main_path


def _rendered_pair(dev):
    """One rendered frame set of the flagship rig, (4, 2, 400, 640) float32 in [0, 1]."""
    from thor_slam_tpu_torch.utils.flagship import flagship_rig

    sources = flagship_rig(4, 640, 400, 512)[3]
    frames = np.stack([[s.render_frame(3, eye) for eye in (0, 1)] for s in sources])
    return (torch.from_numpy(frames).float() * (1.0 / 255.0)).to(dev)


def check_fast(fast_cuda, dev) -> dict:
    """FAST kernel vs plain (<= 1e-6; it has been 0.0) at the main path's
    shape, the stereo pair's 8 images, 720p, ragged shapes (W % 4 != 0, H
    and W below one tile, H = 1, a tile edge inside the last column) and a
    rendered frame set; times the 4- and 8-image launches on the noise
    image and the 8-image launch on the rendered one."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    main_path = None
    shapes = [(4, 400, 640), (8, 400, 640), (4, 720, 1280), (1, 37, 53), (2, 1, 9), (1, 3, 3), (3, 33, 66),
              (1, 65, 129), (2, 400, 642), "rendered"]
    for shape in shapes:
        images = _rendered_pair(dev).reshape(8, 400, 640) if shape == "rendered" else torch.rand(shape, generator=gen).to(dev)
        raw_k, nms_k = fast_cuda.fast_scores_cuda(images, 0.05)
        raw_p, nms_p = fast_cuda.fast_scores_plain(images, 0.05)
        torch.cuda.synchronize()
        err = max(float((raw_k - raw_p).abs().max()), float((nms_k - nms_p).abs().max()))
        corners, peaks = int((raw_k > 0).sum()), int((nms_k > 0).sum())
        if not err <= 1e-6:
            raise AssertionError(f"FAST kernel differs from its plain version by {err} at {shape}")
        label = f"fast9_nms C,H,W={','.join(map(str, images.shape))}" + (" (rendered flagship frame set)" if shape == "rendered" else "")
        if images.shape[1:] != (400, 640) and shape != (4, 720, 1280):
            print(f"{label}: max_abs_err={err} corners={corners} nms_peaks={peaks}")
            continue
        kernel = lambda: fast_cuda.fast_scores_cuda(images, 0.05)  # noqa: E731
        dev_ms = device_ms(kernel)
        ms = call_ms(kernel)
        plain_ms = call_ms(lambda: fast_cuda.fast_scores_plain(images, 0.05))
        nbytes = 3 * images.numel() * 4  # images in, raw and NMS maps out
        print(
            f"{label}: max_abs_err={err} corners={corners} ({corners / images.numel():.2%}) nms_peaks={peaks} device "
            f"{dev_ms:.4f} ms  call {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms(nbytes):.4f} ms"
        )
        row = dict(max_abs_err=err, ms=dev_ms, call_ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms(nbytes), bound_by="bytes", library_ms=None)
        if shape == (4, 400, 640):  # one eye's images: the launch of the design before the pair launch
            one_eye = dict(four_image_ms=dev_ms, four_image_call_ms=ms, four_image_bound_ms=bound_ms(nbytes))
        elif shape == (8, 400, 640):  # the main path's launch: both eyes of the 4 cameras
            main_path = dict(row, **one_eye)
        elif shape == "rendered":
            main_path["rendered_ms"] = dev_ms
    return main_path


def fast_phases(dev) -> None:
    """Where the FAST kernel's time goes (``--fast-phases``): ``csrc/fast.cu``
    built with one phase left out at a time (its ``THOR_FAST_SKIP`` switch)
    and timed on the noise image beside the full kernel."""
    import ctypes

    from thor_slam_tpu_torch.utils import cuda_lib

    out = cuda_lib.BUILD_DIR / "fast_phases"
    out.mkdir(parents=True, exist_ok=True)
    names = {0: "full", 1: "without the scores", 2: "without the corner test and the scores", 3: "without the stores"}
    procs = {
        k: subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", f"-DTHOR_FAST_SKIP={k}", "-o", str(out / f"skip{k}.so"),
             str(cuda_lib.CSRC_DIR / "fast.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in names
    }
    images = torch.rand((4, 400, 640), generator=torch.Generator(device="cpu").manual_seed(SEED + 1)).to(dev)
    raw, nms = torch.empty_like(images), torch.empty_like(images)
    times = {}
    for k, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on fast.cu with THOR_FAST_SKIP={k}:\n{log}")
        lib = ctypes.CDLL(str(out / f"skip{k}.so"))
        lib.thor_fast_nms.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
        lib.thor_fast_nms.restype = ctypes.c_int

        def launch(lib=lib):
            stream = torch.cuda.current_stream().cuda_stream  # the capturing stream under device_ms
            status = lib.thor_fast_nms(images.data_ptr(), raw.data_ptr(), nms.data_ptr(), 4, 400, 640, 0.05, stream)
            if status != 0:
                raise RuntimeError(f"thor_fast_nms: cudaError {status}")

        times[k] = device_ms(launch)
    print("fast9_nms phases, C,H,W=4,400,640 noise, device ms: " + ", ".join(f"{names[k]} {t:.4f}" for k, t in times.items()))


def _sgm_volume(dhw, gen, integral: bool, high: int = 33):
    if integral:
        return torch.randint(0, high, dhw, generator=gen).float().cuda()
    return (torch.rand(dhw, generator=gen) * (high - 1)).cuda()


def check_sgm_scan(sgm_cuda, dev) -> dict:
    """Scan kernel vs plain, bit-exact, at every listed shape, with integral
    and non-integral penalties: each direction and ``add_to`` case of the
    single-scan entry on the views of a (D, H, W) volume, and the
    4-direction path (4 and 2 paths). Then the main path's launches and
    timing."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
    views = {"horizontal": lambda v: v.permute(2, 0, 1), "vertical": lambda v: v.permute(1, 0, 2)}
    cases, err = 0, 0.0
    for dhw in SGM_SHAPES:
        for p1, p2 in SGM_PENALTIES:
            integral = p1 == int(p1)
            cost = _sgm_volume(dhw, gen, integral)
            add = _sgm_volume(dhw, gen, True, 129)
            for name, view in views.items():
                for reverse in (False, True):
                    for add_to in (None, view(add)):
                        got = sgm_cuda.sgm_aggregate_dir_cuda(view(cost), p1, p2, reverse, add_to)
                        want = sgm_cuda.sgm_aggregate_dir_plain(view(cost), p1, p2, reverse, add_to)
                        torch.cuda.synchronize()
                        err = max(err, float((got - want).abs().max()))
                        if not torch.equal(got, want):
                            raise AssertionError(
                                f"SGM scan differs from its plain version at D,H,W={dhw} P={p1},{p2} {name} "
                                f"reverse={reverse} add={add_to is not None}: {float((got - want).abs().max())}"
                            )
                        cases += 1
            for num_paths in (4, 2):
                got = sgm_cuda.sgm_aggregate_4dir_cuda(cost, p1, p2, num_paths)
                want = sgm_cuda.sgm_aggregate_4dir_plain(cost, p1, p2, num_paths)
                torch.cuda.synchronize()
                err = max(err, float((got - want).abs().max()))
                if not torch.equal(got, want):
                    raise AssertionError(f"{num_paths}-path aggregation differs at D,H,W={dhw} P={p1},{p2}")
                cases += 1
            del cost, add, got, want
    print(f"sgm_scan: {cases} cases exact (max_abs_err {err}) at D,H,W in {SGM_SHAPES}, P1,P2 in {SGM_PENALTIES}")

    # The main path: D = 64 at 400x640, integral costs.
    d, h, w = RGBD_DISPARITIES, 400, 640
    cost = _sgm_volume((d, h, w), gen, True)
    path = lambda: sgm_cuda.sgm_aggregate_4dir_cuda(cost, P1, P2)  # noqa: E731
    sgm_cuda.reset_counts()
    path()
    launches = sgm_cuda.counts["sgm_scan"]["kernel"]
    dev_ms = device_ms(path)
    ms = call_ms(path)
    plain_ms = call_ms(lambda: sgm_cuda.sgm_aggregate_4dir_plain(cost, P1, P2), reps=3, warmup=1)
    nbytes = 2 * cost.numel() * 4  # V in, V out
    # The dependent chain alone: one line of 4096 steps (one warp).
    line = _sgm_volume((4096, d, 1), gen, True)
    chain_ms = device_ms(lambda: sgm_cuda.sgm_aggregate_dir_cuda(line, P1, P2, False), calls=4)
    ns_per_step = chain_ms * 1e6 / 4096
    chain_bound_ms = (w + w + h) * ns_per_step / 1e6  # the longest line of each launch: 640, 640, 400 steps
    print(
        f"sgm_aggregate_4dir D,H,W={d},{h},{w}: device {dev_ms:.4f} ms ({launches} scan launches)  call {ms:.4f} ms  "
        f"plain {plain_ms:.4f} ms (over 3 reps)  "
        f"bound {bound_ms(nbytes):.4f} ms (V in + V out, {nbytes / 1e6:.1f} MB); dependent chain "
        f"{ns_per_step:.2f} ns a step (one 4096-step line), {chain_bound_ms:.4f} ms over 640 + 640 + 400 steps"
    )
    return dict(max_abs_err=err, ms=dev_ms, call_ms=ms, plain_ms=plain_ms, bound_ms=bound_ms(nbytes),
                bound_by="bytes", library_ms=None, launches_per_call=launches, chain_ns_per_step=ns_per_step)


def check_winner(sgm_cuda, dev) -> dict:
    """Winner/LR kernel vs plain, exact, on tie-heavy integer volumes and on
    non-integral ones, at every listed shape; then the main path's timing."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 3)
    cases, err = 0, 0.0
    for dhw in SGM_SHAPES + [(64, 400, 600)]:
        for integral in (True, False):
            agg = _sgm_volume(dhw, gen, integral, 400)
            got = sgm_cuda.winner_lr_cuda(agg, dhw[0])
            want = sgm_cuda.winner_lr_plain(agg, dhw[0])
            torch.cuda.synchronize()
            err = max([err] + [float((g.double() - x.double()).abs().max()) for g, x in zip(got, want)])
            if not all(torch.equal(g, x) for g, x in zip(got, want)):
                raise AssertionError(f"winner/LR kernel differs from its plain version at {dhw}, integral={integral}")
            cases += 1
    print(f"sgm_winner_lr: {cases} cases exact (max_abs_err {err}) at D,H,W in {SGM_SHAPES + [(64, 400, 600)]}")
    d, h, w = RGBD_DISPARITIES, 400, 640
    agg = _sgm_volume((d, h, w), gen, True, 400)
    kernel = lambda: sgm_cuda.winner_lr_cuda(agg, d)  # noqa: E731
    dev_ms = device_ms(kernel)
    ms = call_ms(kernel)
    plain_ms = call_ms(lambda: sgm_cuda.winner_lr_plain(agg, d))
    nbytes = agg.numel() * 4 + 6 * h * w * 4  # V in, six planes out
    print(
        f"sgm_winner_lr D,H,W={d},{h},{w}: device {dev_ms:.4f} ms  call {ms:.4f} ms  plain {plain_ms:.4f} ms  "
        f"bound {bound_ms(nbytes):.4f} ms ({nbytes / 1e6:.1f} MB)"
    )
    return dict(max_abs_err=err, ms=dev_ms, call_ms=ms, plain_ms=plain_ms, bound_ms=bound_ms(nbytes),
                bound_by="bytes", library_ms=None)


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
    agg = timed("aggregate", lambda: sgm_cuda.sgm_aggregate_4dir(cost, P1, P2))
    winners = timed("winner/LR", lambda: sgm_cuda.winner_lr(agg, RGBD_DISPARITIES))
    depth = timed("tail + depth", lambda: stereo.disparity_to_depth(
        *stereo.disparity_from_winners(*winners, RGBD_DISPARITIES), sr.fx, sr.baseline_m
    ))
    aligned = timed("align to color", lambda: processor.align(depth))
    depth_mm = timed("u16 encode", lambda: stereo.depth_to_millimeters_u16(aligned))
    timed("fetch", lambda: (color_img.cpu().numpy(), depth_mm.cpu().numpy()))
    return ms


def run_slice(dev, scan_launches: int) -> dict:
    """The tracking slice with an RGB-D frame every RGBD_EVERY ticks;
    ``scan_launches`` is what one 4-direction aggregation launched in the
    kernel phase, which every RGB-D frame must match."""
    from thor_slam_tpu_torch.camera.rig import CameraRig
    from thor_slam_tpu_torch.slam.interface import SlamConfig, TrackingState
    from thor_slam_tpu_torch.utils.evaluation import ate_rmse
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
    # One gather launch per KLT level and tick (both frames), one per keyframe
    # for BRIEF (both eyes); one FAST launch per keyframe (both eyes).
    want_gathers = params.klt_levels * TICKS + keyframes
    if counts["patch_gather"]["kernel"] != want_gathers:
        raise AssertionError(
            f"patch gather launched {counts['patch_gather']['kernel']}, not {params.klt_levels} x {TICKS} + {keyframes}"
        )
    if counts["fast9_nms"]["kernel"] != keyframes or keyframes == 0:
        raise AssertionError(f"FAST launched {counts['fast9_nms']['kernel']} for {keyframes} keyframes")
    rgbd_frames = TICKS // RGBD_EVERY
    if len(rgbd_ms) != rgbd_frames:
        raise AssertionError(f"{len(rgbd_ms)} RGB-D frames, expected {rgbd_frames}")
    if scan_launches > 3 or counts["sgm_scan"]["kernel"] != scan_launches * rgbd_frames:
        raise AssertionError(
            f"SGM scan launched {counts['sgm_scan']['kernel']} for {rgbd_frames} frames, not {scan_launches} (<= 3) each"
        )
    if counts["sgm_winner_lr"]["kernel"] < rgbd_frames:
        raise AssertionError(f"winner/LR launched {counts['sgm_winner_lr']['kernel']} < {rgbd_frames}")
    if any(c["plain"] for c in counts.values()):
        raise AssertionError(f"plain versions ran on the main path: {counts}")
    if not max(rels) < MAX_MEDIAN_REL_ERR or not min(shares) > MIN_VALID_SHARE:
        raise AssertionError(f"RGB-D depth off the bar: valid shares {shares}, median rel errors {rels}")
    return {name: c["kernel"] for name, c in counts.items()}, len(rgbd_ms)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sync_ms(dev, fn, reps: int = 5) -> float:
    """Median host-clock ms of ``fn()``, the device synchronized around it,
    after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        _sync(dev)
        t = time.perf_counter()
        fn()
        _sync(dev)
        times.append(1e3 * (time.perf_counter() - t))
    return statistics.median(times)


def _counts() -> dict:
    from thor_slam_tpu_torch.ops import fast_cuda, patches_cuda

    return {"patch_gather": dict(patches_cuda.counts), "fast9_nms": dict(fast_cuda.counts)}


def _reset_counts() -> None:
    from thor_slam_tpu_torch.ops import fast_cuda, patches_cuda

    patches_cuda.reset_counts()
    fast_cuda.reset_counts()


def render_session(num_cams, width, height, max_keypoints, ticks, clock_offsets=None, blackout=()):
    """(calibration, trajectory, frame sets) of the revisit orbit with the
    IMU of source 0; frames on ``blackout`` ticks are black."""
    from thor_slam_tpu_torch.camera.rig import CameraRig
    from thor_slam_tpu_torch.utils.flagship import flagship_rig

    _, _, calibration, sources, _, traj = flagship_rig(
        num_cams, width, height, max_keypoints, angular_rate=FULL_RATE, clock_offsets=clock_offsets
    )
    frames = []
    with CameraRig(sources, rig_extrinsics=calibration.rig_extrinsics, imu_source=sources[0].name) as rig:
        for i in range(ticks):
            fs = rig.get_synchronized_frames()
            if i in blackout:  # sensor dropout
                for source_frames in fs.frame_sets.values():
                    for f in source_frames.frames:
                        f.image = np.zeros_like(f.image)
            frames.append(fs)
    return calibration, traj, frames


def _angle_deg(a: np.ndarray, b: np.ndarray) -> float:
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def run_full_engine(dev, num_cams=4, width=640, height=400, max_keypoints=512, ticks=FULL_TICKS) -> dict:
    """Session 1 (revisit orbit, defaults) and session 2 (relocalization
    against session 1's saved map). Returns what was measured."""
    import tempfile

    from thor_slam_tpu_torch.slam.interface import SlamConfig, TrackingState
    from thor_slam_tpu_torch.utils.evaluation import ate_rmse
    from thor_slam_tpu_torch.engine import ba, loop, posegraph
    from thor_slam_tpu_torch.engine.imu import GRAVITY_W
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine

    config = SlamConfig(num_cameras=2 * num_cams)  # loop closure on: the default
    overrides = dict(max_keypoints=max_keypoints, **FULL_PARAMS)
    t0 = time.perf_counter()
    calibration, traj, frames = render_session(num_cams, width, height, max_keypoints, ticks, blackout=BLACKOUT)
    render_s = time.perf_counter() - t0
    print(
        f"engine: rendered {ticks} frame sets ({num_cams} x 2 x {width}x{height}, IMU on source 0, "
        f"black on ticks {BLACKOUT.start}-{BLACKOUT.stop - 1}) in {render_s:.1f} s"
    )

    engine = TorchSlamEngine(params=overrides, device=dev, seed=SEED, **FULL_ENGINE_ARGS)
    engine.initialize(calibration, config)
    closures = []
    poll = engine._loop.poll

    def logged_poll(*args, **kwargs):
        res = poll(*args, **kwargs)
        if res is not None:
            t_corr, _, _, info = res
            db = engine._loop.db
            closures.append(dict(
                info, query_ts=round(db[info["qi"]]["ts"], 3), cand_ts=round(db[info["ci"]]["ts"], 3),
                corr_cm=round(float(np.linalg.norm(t_corr[:3, 3])) * 100, 3),
            ))
        return res

    engine._loop.poll = logged_poll
    _sync(dev)
    _reset_counts()
    gt0 = traj.pose(frames[0].timestamp)
    tick_ms, states, est, world, gt = [], [], [], [], []
    ba_applied = 0
    skips: dict[str, int] = {}
    for i, fs in enumerate(frames):
        t = time.perf_counter()
        pose = engine.process_frames(fs)
        _sync(dev)
        tick_ms.append(1e3 * (time.perf_counter() - t))
        diag = engine.last_diagnostics
        states.append(engine.get_tracking_state())
        ba_applied += "ba_rms" in diag
        for key in ("ba_skip", "loop_skip"):
            if key in diag:
                kind = f"{key}:{str(diag[key]).split()[0].split('=')[0]}"
                skips[kind] = skips.get(kind, 0) + 1
        if pose is not None and i not in BLACKOUT:
            est.append(pose.position.copy())
            world.append(engine.get_world_pose(pose).position)
            gt.append((np.linalg.inv(gt0) @ traj.pose(fs.timestamp))[:3, 3])
    engine.flush()
    counts_1 = _counts()
    diag = engine.last_diagnostics
    est, world, gt = np.asarray(est), np.asarray(world), np.asarray(gt)
    imu = engine._imu
    g_true = np.linalg.inv(gt0)[:3, :3] @ GRAVITY_W
    outside = [s for i, s in enumerate(states) if i > 3 and i not in BLACKOUT]
    out = dict(
        render_s=render_s,
        tick_ms=tick_ms,
        tracking_share=float(np.mean([s == TrackingState.TRACKING for s in outside])),
        loops_closed=engine.loops_closed,
        ba_applied=ba_applied,
        skips=skips,
        gravity_n=imu.gravity_n,
        gravity_norm=float(np.linalg.norm(imu.gravity_w)) if imu.gravity_w is not None else float("nan"),
        gravity_err_deg=_angle_deg(imu.gravity_w, g_true) if imu.gravity_w is not None else float("nan"),
        accel_pred=bool(diag.get("accel_pred")),
        imu_empty_windows=engine.imu_empty_windows,
        # Both trajectories start at the first pose, the frame of the truth:
        # the absolute error is what loop closure must lower. The aligned
        # ATE (rigid Umeyama fit) is printed beside it.
        ate_odom=ate_rmse(est, gt, align=False),
        ate_map=ate_rmse(world, gt, align=False),
        ate_odom_aligned=ate_rmse(est, gt),
        ate_map_aligned=ate_rmse(world, gt),
        end_err_odom=float(np.linalg.norm(est[-1] - gt[-1])),
        end_err_map=float(np.linalg.norm(world[-1] - gt[-1])),
        map_correction_m=float(np.linalg.norm(engine.map_t_odom[:3, 3])),
        keyframes=len(engine.get_map().keyframe_poses),
        counts_session1=counts_1,
    )
    print(
        f"engine: {ticks} ticks, ms/tick median {statistics.median(tick_ms):.3f} p95 "
        f"{float(np.percentile(tick_ms, 95)):.3f} max {max(tick_ms):.3f} (first {tick_ms[0]:.1f})"
    )
    print(
        f"engine: TRACKING on {out['tracking_share']:.1%} of the ticks outside the blackout after tick 3; "
        f"keyframes {out['keyframes']}, loops closed {out['loops_closed']}, BA applied on {ba_applied} "
        f"keyframes; skips {json.dumps(skips)}"
    )
    print(f"engine: closures {json.dumps(closures)}")
    print(
        f"engine: gravity n={out['gravity_n']} |g|={out['gravity_norm']:.4f} m/s^2, "
        f"{out['gravity_err_deg']:.3f} deg from the truth; accel_pred {out['accel_pred']}, empty IMU windows "
        f"{out['imu_empty_windows']}, gyro bias {diag.get('gyro_bias_rad_s', float('nan')):.5f} rad/s"
    )
    print(
        f"engine: ATE (unaligned) odometry {out['ate_odom'] * 100:.3f} cm, map-lifted {out['ate_map'] * 100:.3f} cm; "
        f"aligned {out['ate_odom_aligned'] * 100:.3f} / {out['ate_map_aligned'] * 100:.3f} cm; "
        f"end error odometry {out['end_err_odom'] * 100:.3f} cm, map-lifted {out['end_err_map'] * 100:.3f} cm; "
        f"|map_t_odom| {out['map_correction_m'] * 100:.3f} cm"
    )
    print(f"engine: session 1 launch counts {json.dumps(counts_1)}")

    # Synchronized times of one solve of each backend stage, on the final state.
    built = engine._ba.build_problem({})
    lb = engine._loop
    q = lb.db[-1]
    q_desc = torch.from_numpy(np.ascontiguousarray(q["desc"][0]).view(np.int32)).to(dev)
    q_valid = torch.from_numpy(q["valid"][0]).to(dev)
    mask = lb._eligible(lb.db[:-1])
    cand = loop.find_candidate(q_desc, q_valid, lb._dev_desc, lb._dev_valid, mask)
    slot, cam = divmod(int(cand.keyframe), num_cams)
    cand_e = next(e for e in lb.db if e["slot"] == slot)
    obs_norm = lb._obs_norm(q["obs_px"][0])
    graph, _ = lb.build_graph(0, len(lb.db) - 1, np.linalg.inv(lb.db[0]["world_t_body"]) @ q["world_t_body"])
    stage_ms = dict(
        bundle_adjust=sync_ms(dev, lambda: ba.bundle_adjust(built[0], huber_delta=0.004)) if built else None,
        find_candidate=sync_ms(dev, lambda: loop.find_candidate(q_desc, q_valid, lb._dev_desc, lb._dev_valid, mask)),
        verify_candidate=sync_ms(dev, lambda: lb._verify(cand_e, cam, obs_norm, q_desc, q_valid, 0)),
        posegraph=sync_ms(dev, lambda: posegraph.optimize(graph)),
    )
    out["stage_ms"] = stage_ms
    print(
        "engine: one solve, synchronized, median of 5 (ms): "
        + ", ".join(f"{k} {v:.3f}" if v is not None else f"{k} not measured" for k, v in stage_ms.items())
        + f" (DB {len(lb.db)} keyframes x {num_cams} cameras, pose graph {graph.poses.shape[0]} nodes)"
    )

    # Session 2: relocalize against the saved map, clocks 1 s later.
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/map"
        if not engine.save_map(path):
            raise AssertionError("save_map failed")
        cal2, traj2, frames2 = render_session(
            num_cams, width, height, max_keypoints, RELOC_TICKS, clock_offsets=(RELOC_OFFSET_S,) * num_cams
        )
        eng2 = TorchSlamEngine(params=overrides, device=dev, seed=SEED, **FULL_ENGINE_ARGS)
        eng2.initialize(cal2, config)
        if not eng2.load_map(path):
            raise AssertionError("load_map failed")
    attempts = []
    attempt = eng2._loop.relocalize_attempt

    def counted_attempt(*args, **kwargs):
        before = _counts()
        _sync(dev)
        t = time.perf_counter()
        pose = attempt(*args, **kwargs)
        _sync(dev)
        after = _counts()
        attempts.append(dict(
            ok=pose is not None,
            ms=1e3 * (time.perf_counter() - t),
            delta={k: {w: after[k][w] - before[k][w] for w in after[k]} for k in after},
        ))
        return pose

    eng2._loop.relocalize_attempt = counted_attempt
    eng2.relocalize()
    _reset_counts()
    errs = []
    for fs in frames2:
        pose = eng2.process_frames(fs)
        if pose is not None:
            g_map = np.linalg.inv(gt0) @ traj2.pose(fs.timestamp)
            errs.append(float(np.linalg.norm(pose.position - g_map[:3, 3])))
    out.update(
        reloc_attempts=attempts,
        reloc_ok=not eng2._want_reloc,
        reloc_state=eng2.get_tracking_state(),
        reloc_errs=errs,
        counts_session2=_counts(),
    )
    print(
        f"engine: relocalization attempts {json.dumps(attempts)}; state after {RELOC_TICKS} ticks "
        f"{out['reloc_state'].name}; position error in the saved map's frame median "
        f"{np.median(errs) * 100 if errs else float('nan'):.3f} cm (max {max(errs, default=float('nan')) * 100:.3f})"
    )
    print(f"engine: session 2 launch counts {json.dumps(out['counts_session2'])}")
    return out


def check_full_engine(r: dict, kernels: bool = True) -> dict:
    """The full-engine phase's bars; returns its kernel launches."""
    from thor_slam_tpu_torch.slam.interface import TrackingState

    failures = []

    def need(ok, what):
        if not ok:
            failures.append(what)

    need(r["tracking_share"] >= 0.9, f"TRACKING on {r['tracking_share']:.1%} < 90 % of the ticks outside the blackout")
    need(r["loops_closed"] >= 1, "no loop closed")
    need(r["ba_applied"] >= 2, f"BA applied on {r['ba_applied']} < 2 keyframes")
    need(r["gravity_n"] >= 30, f"gravity observed {r['gravity_n']} < 30 times")
    need(8.0 < r["gravity_norm"] < 12.0, f"|g| = {r['gravity_norm']}")
    need(r["gravity_err_deg"] < 15.0, f"gravity {r['gravity_err_deg']} deg from the truth")
    need(r["accel_pred"], "accel prediction not engaged at the end")
    need(r["imu_empty_windows"] == 0, f"{r['imu_empty_windows']} empty IMU windows")
    need(r["ate_map"] <= r["ate_odom"], f"map-lifted ATE {r['ate_map']} worse than odometry {r['ate_odom']}")
    # The JAX package's drift-recovery bar (tests/test_engine_loop_e2e.py).
    need(
        r["end_err_map"] < 0.7 * r["end_err_odom"],
        f"map-lifted end error {r['end_err_map']} not under 0.7x the odometry's {r['end_err_odom']}",
    )
    need(r["reloc_ok"], "relocalization did not succeed")
    need(r["reloc_state"] == TrackingState.TRACKING, f"state {r['reloc_state']} after relocalization")
    need(bool(r["reloc_errs"]) and np.median(r["reloc_errs"]) < MAX_RELOC_ERR_M, f"relocalized errors {r['reloc_errs']}")
    launches = {
        k: r["counts_session1"][k]["kernel"] + r["counts_session2"][k]["kernel"] for k in r["counts_session1"]
    }
    if kernels:
        ok_attempt = next((a for a in r["reloc_attempts"] if a["ok"]), None)
        need(
            ok_attempt is not None
            and ok_attempt["delta"]["patch_gather"]["kernel"] >= 1
            and ok_attempt["delta"]["fast9_nms"]["kernel"] >= 1
            and all(d["plain"] == 0 for d in ok_attempt["delta"].values()),
            f"the relocalization attempt did not run the FAST and gather kernels: {r['reloc_attempts']}",
        )
        for session in ("counts_session1", "counts_session2"):
            need(all(c["kernel"] > 0 and c["plain"] == 0 for c in r[session].values()), f"{session}: {r[session]}")
    if failures:
        raise AssertionError("full-engine phase: " + "; ".join(failures))
    return launches


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
    if "--fast-phases" in sys.argv[1:]:
        fast_phases(dev)
    scan = check_sgm_scan(sgm_cuda, dev)
    winner = check_winner(sgm_cuda, dev)
    if "--kernels-only" in sys.argv[1:]:
        # Phases 0-2 alone (see the module docstring): no result line.
        print(json.dumps({"kernel_times": dict(patch_gather=patch, fast9_nms=fast, sgm_scan=scan,
                                                sgm_winner_lr=winner)}))
        return 0
    torch.cuda.empty_cache()
    launches, periods = run_slice(dev, scan["launches_per_call"])
    per_period = {name: n / periods for name, n in launches.items()}  # a period: RGBD_EVERY ticks
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    full = check_full_engine(run_full_engine(dev))
    print(f"engine: phase took {time.perf_counter() - t0:.1f} s, launches {json.dumps(full)}")
    for name, n in full.items():
        launches[name] += n

    foreign = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "thor_slam_tpu")]
    if foreign:
        raise AssertionError(f"imported {foreign[:5]}")
    rows = [
        ("patch_gather", "patches.cu", "thor_slam_tpu/ops/patches_pallas.py:68", patch),
        ("fast9_nms", "fast.cu", "thor_slam_tpu/ops/fast_pallas.py:98", fast),
        ("sgm_scan", "sgm.cu", "thor_slam_tpu/ops/sgm_pallas.py:61", scan),
        ("sgm_winner_lr", "sgm.cu", "thor_slam_tpu/ops/sgm_pallas.py:249", winner),
    ]
    record = {"kernels": []}
    for name, src, replaces, m in rows:
        calls = per_period[name] / m.get("launches_per_call", 1)
        record["kernels"].append(dict(
            name=name, route="cuda", source=f"thor_slam_tpu_torch/csrc/{src}", replaces=replaces,
            launches=launches[name], launches_per_period=per_period[name],
            loss_ms_per_period=calls * (m["ms"] - m["bound_ms"]), **m,
        ))
    ranked = sorted(record["kernels"], key=lambda k: -k["loss_ms_per_period"])
    print(
        f"ranking by launches x (device ms - bound ms) per period of {RGBD_EVERY} ticks: "
        + ", ".join(f"{k['name']} {k['loss_ms_per_period']:.4f} ms" for k in ranked)
    )
    print(json.dumps(record))
    device = {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
