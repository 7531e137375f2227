#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. With
``--kernels-only`` it runs phases 0-2 alone and prints their numbers, no
result line: a kernel PR copies the script into a ``git archive`` of its
parent and runs parent, change, change, parent in one call, so both
versions' kernels are checked and timed by the same code. With
``--fast-phases`` it also times the FAST kernel built with one phase left
out at a time, which shows where its time goes. With ``--tick-launches``
it builds the kernels, then counts one tracking tick's kernel launches by
phase under torch.profiler and times unprofiled ticks, and stops: copied
into a ``git archive`` of a parent it gives both trees' tables in one
call. With ``--engine-only`` it builds the kernels and runs phase 5
alone, printing every BA solve's outcome by tick: copied into a parent's
tree it shows which gate an outcome of that phase turned on. With
``--bench-only`` it builds the kernels and runs phase 13 alone. With
``--patrol [seed ...]`` it builds the kernels and records the benchmark's
patrol cell (``oak4-640x400-patrol.orbit-loop``) once a seed through the
benchmark's own harness, untraced, with the bfloat16 control beside it,
checks every pose-graph solve the run made against the plain reference,
and prints a JSON line a seed (``run_patrol``); no result line. It

0. requires a CUDA device, prints the card's name and power limit and pins
   full-f32 precision;
1. builds the kernels from ``thor_slam_tpu_torch/csrc`` and prints the
   build time and the compiler's per-kernel resource report;
2. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (patch gather exactly: the single-stack entry and
   the pair entry, which gathers from two stacks in one launch and clips
   the centres, also on ragged shapes, M = 1 and strided stacks; FAST-9
   within 1e-6 at 4 and 8 images of 400x640, 720p, ragged shapes and a
   rendered frame set; both also at the mono rigs' shapes, five cameras
   and two, with a mono camera's right image zero; the SGM
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
   BA, the gravity estimate and the map-lifted ATE; times one BA solve
   (eager, and graphed as the engine runs it, each with its launches and
   copies counted; the graphed one may make at most
   BA_GRAPHED_MAX_LAUNCHES), one loop lookup, one verification and one
   pose-graph solve; then saves
   the map, and a fresh engine on a rig whose clocks start 1 s later loads
   it, relocalizes (through the FAST and gather kernels) and tracks 10
   ticks in its frame (session 2).
6. drives the mono paths at the same width (640x400, 512 slots a camera):
   a mixed rig, the four stereo cameras plus one mono camera between two
   of them, over 60 ticks (ATE, tracking held, the mono camera's bank
   seeded from the stereo cameras' landmarks); an all-mono rig of two
   cameras over 70 ticks (the two-view bootstrap, each attempt's time and
   outcome read from the engine's diagnostics, then tracking up to scale:
   TRACKING held from the bootstrap on, Sim(3)-aligned ATE over the second
   half, each camera's promoted landmarks as the median over the last 20
   ticks); and 10 ticks of the slice with ``median_prefilter`` and
   ``oriented_descriptors`` on. Before it is driven, each rig's own frames
   go through both kernels and their plain versions at the rig's shapes.
   Each phase asserts its gather and FAST launch counts as the slice does,
   and no plain call.
7. drives the engine modes, on frames already rendered: ``deployed``, the
   full-engine phase's 240 ticks, save, load and relocalization again with
   the deployed YAML's backend values (pipelined at depth 1, light ticks,
   adaptive half-res), held to the same bars plus the latency contract
   (the first call returns None, ``flush()`` the last tick's pose), light
   ticks that never refresh and ``upload_stats`` that add up; its calls
   are timed without a synchronization after each, and a second run under
   torch.profiler counts the synchronizing runtime calls per call and
   inside ``track_step`` by tick type (light, full, keyframe); ``deep``,
   pipeline depth 4 against depth 1 (BA, IMU, loop closure) on the slice's
   ticks with the IMU packets of its trajectory added, and on the first 60
   ticks of the full-engine render (a flying start: its ATE is printed,
   see DEEP_DEPTH); ``defer_sync``, the slice's 40 ticks (VO only)
   against the synchronous run of the same frames; ``half``, the slice's
   ticks with half-resolution light ticks, then the adaptive controller
   told the stream is paced (where it degraded is printed, no bar). PR 6's
   phases run the synchronous engine with light ticks off, as then. Every
   phase of the modes asserts the launch identities. To keep the run short,
   ``deep``'s flying start is the first 30 ticks of the full render,
   ``defer_sync`` and ``half`` drive the slice's first 20 ticks, and 8
   deployed calls are profiled (DEEP_TICKS, MODE_TICKS, SYNC_PROFILE_TICKS);
8. dense mapping (``mapping:`` lines) at the deployed grid, 256x256x128 at
   0.05 m with colour (``MapperConfig()``): the slice's 8 RGB-D frames made
   with ``fetch=False`` and integrated by ``DenseMapper`` at the engine's
   poses composed with the product's frame. Times each integrate (the host's
   side unsynchronized, the device's between CUDA events) against its bound
   (the grid read and written, depth and colour read, over 3.35 TB/s), the
   bulk integrator (which must give the sequential grid), decay, one forced
   recenter, the surface cloud, the mesh and the costmap slice; the grid's
   bytes and the peak memory. Asserts 0 synchronizing runtime calls per
   integrate under torch.profiler, the SGM launch identity of the 8 frames,
   a mesh with triangles and no budget hit, an occupied costmap, and the
   accuracy against a grid of the same frames and poses with the renderer's
   true depth (MAP_MIN_TRUTH_SHARE, MAP_MAX_MEDIAN_TSDF_ERR_VOX, the comment
   above them says which voxels each holds);
9. the runner (``runner:`` lines): the port's ``run_pipeline.run`` for 10
   ticks on the card with RUNNER_CONFIG, the deployed YAML's values with the
   synthetic rig (4 sources at 640x400, colour 1280x800) and mapping on at
   the deployed grid; asserts rc 0, the ``Dense map:`` line and the gather,
   FAST and SGM launch identities of its ticks and RGB-D frames;
10. the EuRoC runner (``euroc:`` lines) at EuRoC's own geometry: the port's
   ``make_euroc_synthetic`` writes 200 frames of one stereo camera at
   752x480, 20 fps, with its 200 Hz IMU, on an orbit at 0.7 rad/s that
   revisits its start near frame 180 (EUROC_ARGS; rendered by the pool
   during the deployed phase's profiled calls) into a temporary directory;
   both kernels are held to their plain versions on its own frames (FAST on
   the (2, 480, 752) pair, the last tile column ragged; the pair gather
   with M = 1 x 512); then the port's ``run_euroc.main`` runs in this
   process on the card at its defaults (IMU with the accelerometer, BA,
   loop closure, light ticks). Prints its output, then the frame count,
   fps, odometry, world-frame and map-trajectory ATE, closures and the ms
   per ``process_frames`` (median, p95, max); asserts rc 0, TRACKING from
   the second frame on, the gather and FAST identities of its ticks, and
   an odometry ATE within EUROC_MAX_ATE_FACTOR of the JAX runner's on the
   identical sequence (EUROC_REF_ATE_CM, measured on the CPU).
11. tracking over a mesh of shards (``spmd:`` lines). The card's machine
   has one GPU, so first ``TorchSlamEngine(devices=2)`` must raise the
   reference's ``RuntimeError``; then every mesh repeats the card
   (``devices=[cuda:0] * n``), which runs each kernel at its sharded
   shapes: (a) the slice's 40 ticks (reused) over 2 camera shards (2
   cameras each) and over 4 (1 each), the slice's engine arguments; (b)
   phase 10's sequence, its first 80 frames, through ``run_euroc.main`` at
   its defaults on the single device and over 2 slot shards (2 x 256
   slots, the IMU's prediction feeding the sharded step). Before each run
   both kernels are held to their plain versions at each shard's shapes
   (the gather pair at M = 2 x 1024, 2 x 512 and 2 x 256 on the
   replicated (1, 480, 752) stack; FAST on (4, 400, 640), (2, 400, 640)
   and (2, 480, 752) once per shard). Each run prints ms per tick (median,
   keyframe), the gather and FAST launches (the identities times the shard
   count), ATE, the TRACKING share, whether the ids a keyframe minted are
   unique across shards at every keyframe, and the largest pose
   difference against the single device on the same frames; (a) holds
   ATE < 5 cm, TRACKING by tick 3 and on >= 90 % after, within 0.02 m of
   the slice's poses; (b) TRACKING on >= 90 % after the first keyframe and
   an ATE within 2x the single device's.
12. the measurement tools (``measure:`` lines). First the gather and FAST
   against their plain versions at this phase's shapes (random stacks at
   512 and 256 keypoints a camera, and the flagship's own frames); the
   demos' SGM volume (D = 64, 200x320) is one of the kernel phase's
   shapes. Then ``profile_stages`` with ``--e2e --default`` at 640x400
   with 4 cameras and at 752x480 with 1 (the EuRoC runner's shape; its
   ``--e2e`` split with the runner's engine, by tick type),
   ``ablate_step`` at 640x400 (each variant paired step by step with a
   FULL run of its own), the demos ``rgbd_stream`` (grayscale and
   ``--color``, 3 frames each) and ``test_stream_resolutions`` on the
   card, then the device render of 2 flagship frames against the host
   render (uint8-equal on >= 99.9 % of the pixels). Asserts the gather
   and FAST launches of every stage row and ablation run (the slice's
   identity, less what a stub removes), the SGM scan launches of every
   RGB-D product (as the slice counts them) and 0 plain calls. CPU
   rehearsal: ``run_measure(cpu, 4, shapes=(("160x100", "1", ()),),
   ablate_res="128x96", reps=2, ticks=3, render_cams=2, render_res=(128,
   96), kernels=False)`` (~1 min).
13. the benchmark (``bench:`` lines) at its flagship, 4 stereo cameras at
   1280x720 with 256 slots a camera. First the slice there: 40 frames
   rendered on the card and brought to the host as uint8, as the benchmark
   renders its host frames; both kernels against their plain versions on
   them; the synchronous engine over the 40 ticks (TRACKING by tick 3 and
   on >= 90 % after, ATE < 5 cm, the gather and FAST identities). Then
   ``python -m thor_slam_tpu_torch.bench`` at its defaults in a subprocess,
   its ``BENCH_BUDGET_S`` the time this run has left less a margin
   (CHIP_LIMIT_S, BENCH_MARGIN_S): prints its log and its JSON line, and
   asserts exit code 0, every key non-null, no phase skipped, the card's
   name and power limit as its ``device``, both inlier counts at least
   BENCH_MIN_INLIERS, and that it launched every kernel and no plain
   version (the launches it logs count in the kernels' record). CPU
   rehearsal of the slice: ``run_bench_slice(cpu, res=(320, 180),
   ticks=12, kernels=False)``.

Every phase's frames are rendered ahead by a pool of worker processes (a
frame is a deterministic function of its index), which are idle while ticks
are timed and stopped before the result is printed; the mono, runner and
EuRoC phases' frames render while the deployed phase's profiled calls,
which are counted and not timed, run. The line ``run: <s> s on <card>``
gives the whole run's seconds from the start of ``main`` and the card's
name and power limit again.

Any failure exits non-zero without printing a result. The last line is
``{"ok": true, "device": {...}}``; the line before it is the per-kernel
JSON record, with launches on all main paths and per period of the slice
(5 ticks: one RGB-D frame), and each kernel's loss per period, launches x
(device ms - bound ms), by which the kernels are ranked; before it a
``modes:`` JSON line sums up the engine modes. Imports nothing of JAX or of
the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

from thor_slam_tpu_torch.utils.profiling import LAUNCH_CALLS, kernel_counts, reset_kernel_counts

REPO = Path(__file__).resolve().parent
#: The tracker's kernels: the counts its phases hold to their identities.
TRACKER_KERNELS = ("patch_gather", "fast9_nms")
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
# the flagship (D = 64, 400x640), the RGB-D demos' (D = 64, 200x320) and
# the 720p geometry (D = 96).
SGM_SHAPES = [(48, 37, 203), (64, 1, 50), (64, 45, 37), (96, 23, 61), (256, 9, 100), (256, 3, 300),
              (64, 400, 640), (64, 200, 320), (96, 720, 1280)]
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
# Mono phases. The mixed rig's mono camera looks between cameras 0 and 1
# (mounted at yaws 0 and pi/2; ~19 degrees of its view overlap each). The
# all-mono rig is that of tests/test_engine_mono_only.py, and so are its bars
# but one. That test (160x120, 256 slots) counts the promoted landmarks at
# its last tick. At this size the bank of promoted landmarks decays and
# recovers in cycles, in the reference too (a pending track that a keyframe
# finds under its parallax floor starts again with a new anchor;
# tests/test_torch_mono.py::test_promoted_landmarks_cycle_alike_at_full_width
# runs both engines at this size), and the count at one tick swings between
# ~10 and ~150: each camera's median over the last MONO_TAIL_TICKS ticks
# must pass that test's bar, the count at the last tick must not be 0, and
# TRACKING must hold from the bootstrap on.
MIXED_TICKS = 60
MIXED_MONO_YAW = np.pi / 4
MIN_SEEDED = 20
MONO_TICKS = 70
MONO_PARAMS = dict(keyframe_min_inliers=40)
MONO_BOOT_BY = 35
MONO_MIN_LANDMARKS = (40, 20)
MONO_TAIL_TICKS = 20
MONO_MAX_ATE_SHARE = 0.15
SWITCH_TICKS = 10
# PR 6's phases run the synchronous engine with light ticks off, as then,
# so that their numbers stay comparable; the phases of the engine modes run
# the deployed YAML's backend values (config/slam_config.yaml: pipelined,
# depth 1, light ticks at their default, adaptive half-res, and the masked-
# camera warm-up that its camera watchdog asks for).
PR6_MODES = dict(pipelined=False, light_ticks=False)
DEPLOYED_MODES = dict(
    prewarm_degraded=True, pipelined=True, pipeline_depth=1, light_ticks=None, light_half_res=False,
    adaptive_half_res=True,
)
DEEP_TICKS = 30  # the first second of the full-engine render, well before its blackout
DEEP_DEPTH = 4
# The full-engine render moves at 1 rad/s from its first tick. At depth d the
# first d dispatches come before any tick is finalized, so the IMU has no
# finalized pose to predict from (the reference's rule too) and tick 1
# tracks against a zero-motion prediction: the bank is lost and the start's
# error stays in the odometry. The ATE bar of tests/test_engine_pipeline_deep.py
# is therefore held on the slice's slower orbit, with its IMU packets added.
MAX_DEFER_ATE_DIFF_M = 1e-4
MODE_TICKS = 20  # the slice's first ticks, which the defer_sync and half phases drive
SYNC_PROFILE_TICKS = 8  # deployed ticks under the profiler, before the blackout
RENDER_WORKERS = 6  # processes that render frames ahead (at most all cores but two)
# Dense mapping: the deployed grid (config/slam_config.yaml mapping section,
# MapperConfig's defaults) fed by the slice's RGB-D frames, held against a
# grid of the same frames and poses with the renderer's true depth. Bars
# (>= 95 % each): the SGM grid's observed voxels on the near side of its
# surface (tsdf >= 0) are observed in the truth grid, and the truth grid's
# observed voxels in the SGM grid; the median |dtsdf| on the voxels both
# observe, and on those inside the truth's truncation band, is at most one
# voxel (0.05 m). The SGM grid's voxels behind its surface are not held to
# the truth's: they lie behind the true surface wherever the product's depth
# lies more than the truncation band (0.2 m) beyond the truth, which ~6 % of
# its valid pixels do at 2-7 m (printed; the product is the reference's to
# 1e-5), so ~8.5 % of all its observed voxels are not in the truth grid.
MAP_FORCED_SHIFT = (8, -8, 0)  # voxels: one recenter, timed on a copy of the grid
MAP_MIN_TRUTH_SHARE = 0.95
MAP_MAX_MEDIAN_TSDF_ERR_VOX = 1.0  # voxels: 0.05 m at the deployed grid
# The runner phase: the port's run_pipeline.run on the deployed YAML's values
# (config/slam_config.yaml; the card's machine has no pyyaml, so they are
# written here) with the synthetic rig of that file's synthetic section at 4
# sources and a 1280x800 colour imager, and mapping on at the deployed grid.
# The file's camera list and nvblox_cameras name the hardware rig (its RGB-D
# camera 192.168.2.25 is not one of the synthetic rig's four), so they are
# left out: in synthetic mode the first source feeds the RGB-D stream.
RUNNER_TICKS = 10
RUNNER_CONFIG = {
    "fps": 30,
    "display": False,
    "urdf_path": "",
    "imu_report_rate": 400,
    "queue_size": 8,
    "rig_queue_size": 10,
    "watchdog_timeout_s": 1.0,
    "backend": {
        "max_keypoints": 512, "enable_ba": True, "enable_loop_closure": True, "use_imu": True, "use_accel": True,
        "pipelined": True, "pipeline_depth": 1, "devices": 1, "light_half_res": False, "adaptive_half_res": True,
        "tracker": {},
    },
    "synthetic": {
        "enabled": True, "num_cameras": 4, "resolution": [640, 400], "baseline_m": 0.075, "trajectory_radius": 1.8,
        "room_half_extents": [5.0, 5.0, 2.5], "color_camera": True, "color_resolution": list(COLOR_RESOLUTION),
    },
    "mapping": {
        "enabled": True, "voxel_size_m": 0.05, "dims": [256, 256, 128], "truncation_vox": 4.0,
        "max_integration_distance_m": 10.0, "integrate_color": True, "recenter_margin_m": 2.0, "slice_axis": 2,
        "slice_band_m": [0.0, 1.0], "esdf_max_distance_m": 2.0, "integrate_every": 1,
    },
}
# Phase 10: the port's EuRoC runner at EuRoC's own geometry (one stereo
# camera, 752x480, 20 fps, 200 Hz IMU) on a synthetic sequence whose orbit
# (0.7 rad/s) revisits its start near frame 180, at the runner's defaults.
EUROC_ARGS = ("--width", "752", "--height", "480", "--fps", "20", "--frames", "200", "--trajectory-rate", "0.7")
# The JAX package's runner on the identical sequence (python -m
# scripts.run_euroc --cpu, on the CPU: odometry ATE, closures, map ATE).
EUROC_REF_ATE_CM, EUROC_REF_LOOPS, EUROC_REF_MAP_ATE_CM = 3.50, 0, 3.35
EUROC_MAX_ATE_FACTOR = 2.0  # the port's odometry ATE on the card against the reference's
# Phase 11: tracking over a mesh of shards on the one card (the mesh repeats
# cuda:0, so every kernel runs at its sharded shapes; no run here has a
# second GPU). The slice's 4 cameras over 2 shards (2 cameras each) and over
# 4 (1 each); phase 10's sequence (1 camera, 512 slots) over 2 slot shards
# of 256, its first SPMD_EUROC_FRAMES frames, with and without the mesh.
SPMD_CAM_SHARDS = (2, 4)
SPMD_SLOT_SHARDS = 2
SPMD_EUROC_FRAMES = 80
SPMD_MAX_POSE_DIFF_M = 0.02  # the reference's bar (tests/test_parallel.py)
SPMD_MAX_ATE_FACTOR = 2.0  # slot-sharded ATE against the single device's (tests/test_engine_spmd.py)
# Phase 12: the measurement tools on the card. profile_stages at the slice's
# shape and at the EuRoC runner's (one camera, 752x480, its --e2e split with
# the runner's engine), each with --e2e and --default; ablate_step at the
# slice's shape; the two SGM demos; the device render against the host render
# on MEASURE_RENDER_FRAMES flagship frames (uint8-equal on MIN_RENDER_U8_EQUAL
# of the pixels, the bar of tests/test_torch_measure.py). The keypoints a
# camera of the stage rows and the ablation, and of --e2e and --default.
MEASURE_SHAPES = (("640x400", "4", ()), ("752x480", "1", ("--e2e-engine", "euroc")))
MEASURE_KEYPOINTS = (512, 256)
MEASURE_ABLATE_RES = "640x400"
MEASURE_RENDER_FRAMES = 2
MIN_RENDER_U8_EQUAL = 0.999
# Phase 5: the graphed BA solve launches one graph; the bound leaves room
# for its copies in and out where a copy launches a kernel.
BA_GRAPHED_MAX_LAUNCHES = 60
# --tick-launches: ticks under the profiler, then unprofiled ticks.
PROFILE_TICKS = 28  # the slice refreshes about every 13th tick: two keyframes
TIMED_TICKS = 30
# Phase 13: the benchmark's flagship, 4 stereo cameras at 1280x720 with 256
# slots a camera (bench.py's defaults), first as the slice (the synchronous
# engine, PR6_MODES, over BENCH_TICKS frames rendered on the card, held to
# the slice's bars), then `python -m thor_slam_tpu_torch.bench` at its
# defaults in a subprocess, given the time the run has left (CHIP_LIMIT_S
# less what has passed and BENCH_MARGIN_S for what follows it) as its
# BENCH_BUDGET_S. Both inlier counts of its line (the last tick of the
# device loop and of the 720p streaming row) must reach BENCH_MIN_INLIERS
# of the 4 x 256 slots; the reference's own last line had 139 and 227. The
# counts are deterministic on the card (seeded draws, no controller in
# either row) but sample the bank between refreshes (a refresh when
# inliers drop under keyframe_min_inliers = 50): a change that moves them
# moves where the sample falls, so read the change before the bar.
BENCH_RES = (1280, 720)
BENCH_KEYPOINTS = 256
BENCH_TICKS = 40
BENCH_MIN_INLIERS = 100
CHIP_LIMIT_S = 1200.0
BENCH_MARGIN_S = 60.0


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
    # (shape, S, M, mono cameras): the slice's three (both KLT levels and
    # BRIEF), the same three of the mixed rig (a fifth, mono camera) and of
    # the all-mono rig (two mono cameras), then M = 1, M a multiple of no
    # block's patch count, a patch as large as the image, a generic size;
    # last the benchmark's flagship (4 x 1280x720, 256 slots a camera): both
    # KLT levels and BRIEF.
    # A mono camera's images in the second stack are zero, as its right eye
    # is when BRIEF gathers both eyes.
    cases = [((4, 400, 640), 19, 2048, 0), ((4, 200, 320), 19, 2048, 0), ((4, 400, 640), 37, 2048, 0),
             ((5, 400, 640), 19, 2560, 1), ((5, 200, 320), 19, 2560, 1), ((5, 400, 640), 37, 2560, 1),
             ((2, 400, 640), 19, 1024, 2), ((2, 200, 320), 19, 1024, 2), ((2, 400, 640), 37, 1024, 2),
             ((3, 41, 37), 9, 1, 0), ((3, 41, 37), 19, 13, 0), ((2, 37, 53), 37, 7, 0), ((1, 64, 48), 5, 1001, 0),
             ((4, 720, 1280), 19, 1024, 0), ((4, 360, 640), 19, 1024, 0), ((4, 720, 1280), 37, 1024, 0)]
    for shape, size, m, mono in cases:
        c, h, w = shape
        stacks, cam, centers = _gather_inputs(gen, shape, m, dev)
        if mono:
            stacks[1][c - mono :] = 0.0
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
              (1, 65, 129), (2, 400, 642), "rendered", "mixed", "all-mono"]
    # The mono rigs' launches: image 2c + eye, a mono camera's right eye zero
    # (the mixed rig's fifth camera; both cameras of the all-mono rig).
    zero_right = {"mixed": ((10, 400, 640), [9]), "all-mono": ((4, 400, 640), [1, 3])}
    for shape in shapes:
        if shape == "rendered":
            images = _rendered_pair(dev).reshape(8, 400, 640)
        elif shape in zero_right:
            images = torch.rand(zero_right[shape][0], generator=gen).to(dev)
            images[zero_right[shape][1]] = 0.0
        else:
            images = torch.rand(shape, generator=gen).to(dev)
        raw_k, nms_k = fast_cuda.fast_scores_cuda(images, 0.05)
        raw_p, nms_p = fast_cuda.fast_scores_plain(images, 0.05)
        torch.cuda.synchronize()
        err = max(float((raw_k - raw_p).abs().max()), float((nms_k - nms_p).abs().max()))
        corners, peaks = int((raw_k > 0).sum()), int((nms_k > 0).sum())
        if not err <= 1e-6:
            raise AssertionError(f"FAST kernel differs from its plain version by {err} at {shape}")
        label = f"fast9_nms C,H,W={','.join(map(str, images.shape))}" + (
            " (rendered flagship frame set)" if shape == "rendered" else
            f" ({shape} rig: images {zero_right[shape][1]} zero)" if shape in zero_right else "")
        if shape in zero_right and int((raw_k[zero_right[shape][1]] != 0).sum()) != 0:
            raise AssertionError(f"FAST found corners in the zero images of the {shape} rig's launch")
        if (images.shape[1:] != (400, 640) and shape != (4, 720, 1280)) or shape in zero_right:
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


def run_slice(dev, scan_launches: int, pool=None) -> dict:
    """The tracking slice with an RGB-D frame every RGBD_EVERY ticks;
    ``scan_launches`` is what one 4-direction aggregation launched in the
    kernel phase, which every RGB-D frame must match."""
    from thor_slam_tpu_torch.camera.rig import CameraRig
    from thor_slam_tpu_torch.camera.types import CameraFrame
    from thor_slam_tpu_torch.slam.interface import SlamConfig, TrackingState
    from thor_slam_tpu_torch.utils.evaluation import ate_rmse
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
    from thor_slam_tpu_torch.pipeline import RGBDProcessor
    from thor_slam_tpu_torch.utils.flagship import flagship_rig

    torch.cuda.reset_peak_memory_stats()
    params, _, calibration, sources, _, traj = flagship_rig(4, 640, 400, 512, color_resolution=COLOR_RESOLUTION)
    src = sources[0]
    t0 = time.perf_counter()
    deliver = submit_renders(pool, sources, TICKS + 1)
    # The colour frame of each RGB-D tick and its true depth render in the
    # pool too (submitted before the stereo frames reach the sources, which
    # are pickled with each job).
    rgbd_ticks = [i for i in range(TICKS + 1) if (i + 1) % RGBD_EVERY == 0 or i == TICKS]
    jobs = {i: pool.submit(_color_and_depth, src, i) for i in rgbd_ticks} if pool is not None else {}
    deliver()
    with CameraRig(sources, rig_extrinsics=calibration.rig_extrinsics) as rig:
        frames = [rig.get_synchronized_frames() for _ in range(TICKS + 1)]
    colors, truth = {}, {}
    for i in rgbd_ticks:
        if frames[i].get_frames_for_source(src.name)[0].sequence_num != i:
            raise AssertionError(f"tick {i} does not carry frame {i} of {src.name}")
        image, truth[i] = jobs[i].result() if jobs else _color_and_depth(src, i)
        # What the source's try_get_latest_rgb_frame gives after tick i.
        colors[i] = CameraFrame(image=image, timestamp=src.frame_time(i), sequence_num=i, camera_name=f"{src.name}_rgb")
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
    warm = TorchSlamEngine(params=overrides, device=dev, seed=SEED, **PR6_MODES)
    warm.initialize(calibration, config)
    for fs in frames[:WARMUP_TICKS]:
        warm.process_frames(fs)
    warm.shutdown()

    engine = TorchSlamEngine(params=overrides, device=dev, seed=SEED, **PR6_MODES)
    engine.initialize(calibration, config)
    torch.cuda.synchronize()
    reset_kernel_counts()
    tick_ms, refreshed, states, est, gt, positions = [], [], [], [], [], []
    rgbd_ms, rgbd_acc, rgbd_items = [], [], []
    gt0 = traj.pose(frames[0].timestamp)
    for i, fs in enumerate(frames):
        t = time.perf_counter()
        pose = engine.process_frames(fs)
        torch.cuda.synchronize()
        tick_ms.append(1e3 * (time.perf_counter() - t))
        refreshed.append(engine.last_diagnostics["refreshed"])
        states.append(engine.get_tracking_state())
        positions.append(None if pose is None else pose.position.copy())
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
            # The mapping phase integrates this tick's product at this pose.
            rgbd_items.append(dict(tick=i, frame_set=fs, color=colors[i], truth=truth[i],
                                   world_t_body=pose.to_4x4_matrix()))
    counts = kernel_counts()
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
    reuse = dict(calibration=calibration, traj=traj, frames=frames[:SWITCH_TICKS], tick_ms=tick_ms[:SWITCH_TICKS],
                 max_keypoints=params.max_keypoints, klt_levels=params.klt_levels, all_frames=frames, ate=ate,
                 positions=positions,
                 processor=processor, rgbd_items=rgbd_items,
                 body_t_left=calibration.get_world_extrinsics(src.name)[0].to_4x4_matrix())
    return {name: c["kernel"] for name, c in counts.items()}, len(rgbd_ms), reuse


def _render_block(source, keys):
    """In a worker process: ``{(n, imager): frame}`` of one source."""
    return {(n, ci): source.render_frame(n, ci) for n, ci in keys}


def _color_and_depth(source, n: int):
    """In a worker process: colour frame ``n`` of ``source`` and the true
    depth along its rays."""
    return source.render_color_frame(n), source.render_color_depth(n)


def submit_renders(pool, sources, ticks: int, block: int = 4):
    """Start rendering the first ``ticks`` frames of every imager of
    ``sources`` in the pool's processes (a frame is a deterministic function
    of its index); returns a function that waits for them and hands them to
    the sources, which deliver them when the rig asks. Without a pool the
    sources render as they go."""
    blocks = []
    for source in sources if pool is not None else ():
        imagers = len(source.get_extrinsics())
        for start in range(0, ticks, block):
            keys = [(n, ci) for n in range(start, min(start + block, ticks)) for ci in range(imagers)]
            blocks.append((source, pool.submit(_render_block, source, keys)))

    def deliver() -> None:
        # A block's source is pickled when the block is sent to a worker, not
        # when it is submitted: the sources get their frames only after every
        # block is back, or the later blocks would carry the earlier blocks'
        # frames along.
        done = [(source, future.result()) for source, future in blocks]
        for source, frames in done:
            source.prerender(frames)

    return deliver


def prerender(pool, sources, ticks: int, block: int = 4) -> None:
    """Render ahead and deliver (``submit_renders``), waiting for the
    workers: they are idle whenever ticks are timed."""
    submit_renders(pool, sources, ticks, block)()


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


def render_session(num_cams, width, height, max_keypoints, ticks, clock_offsets=None, blackout=(), pool=None):
    """(calibration, trajectory, frame sets) of the revisit orbit with the
    IMU of source 0; frames on ``blackout`` ticks are black."""
    from thor_slam_tpu_torch.camera.rig import CameraRig
    from thor_slam_tpu_torch.utils.flagship import flagship_rig

    _, _, calibration, sources, _, traj = flagship_rig(
        num_cams, width, height, max_keypoints, angular_rate=FULL_RATE, clock_offsets=clock_offsets
    )
    frames = []
    prerender(pool, sources, ticks)
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


def render_full_inputs(num_cams=4, width=640, height=400, max_keypoints=512, ticks=FULL_TICKS, pool=None) -> dict:
    """The frame sets of both sessions of the full-engine phase: the revisit
    orbit with its blackout, then the relocalization session's rig 1 s
    later."""
    t0 = time.perf_counter()
    calibration, traj, frames = render_session(num_cams, width, height, max_keypoints, ticks, blackout=BLACKOUT, pool=pool)
    render_s = time.perf_counter() - t0
    print(
        f"engine: rendered {ticks} frame sets ({num_cams} x 2 x {width}x{height}, IMU on source 0, "
        f"black on ticks {BLACKOUT.start}-{BLACKOUT.stop - 1}) in {render_s:.1f} s"
    )
    cal2, traj2, frames2 = render_session(
        num_cams, width, height, max_keypoints, RELOC_TICKS, clock_offsets=(RELOC_OFFSET_S,) * num_cams, pool=pool
    )
    return dict(num_cams=num_cams, max_keypoints=max_keypoints, calibration=calibration, traj=traj, frames=frames,
                cal2=cal2, traj2=traj2, frames2=frames2, render_s=render_s)


def log_finalized(engine) -> list:
    """Wrap the engine's finalize: every finalized tick's timestamp, tick
    type, diagnostics, pose, lifted pose and state, in order (one call of
    a pipelined engine may finalize several ticks, and returns one pose)."""
    log = []
    finalize = engine._finalize_values

    def logged(rec):
        pose = finalize(rec)
        log.append(dict(
            ts=rec["ts"], light=rec["light"], half=rec["half"], diag=dict(engine.last_diagnostics), pose=pose,
            world=None if pose is None else engine.get_world_pose(pose), state=engine.get_tracking_state(),
        ))
        return pose

    engine._finalize_values = logged
    return log


def run_full_engine(dev, inputs: dict, label: str = "engine", stage_solves: bool = True, **engine_args) -> dict:
    """Session 1 (revisit orbit) and session 2 (relocalization against
    session 1's saved map) on the frame sets of ``render_full_inputs``,
    with the full-engine overrides and ``engine_args``. A synchronous
    engine's calls are timed with the device synchronized after each; a
    pipelined engine's are not (that would undo the overlap), and its
    latency contract is checked: the first call returns None, ``flush()``
    the last tick's pose. ``stage_solves`` times one solve of each backend
    stage on the final state. Returns what was measured."""
    from thor_slam_tpu_torch.slam.interface import SlamConfig, TrackingState
    from thor_slam_tpu_torch.utils.evaluation import ate_rmse
    from thor_slam_tpu_torch.engine.imu import GRAVITY_W
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine

    num_cams = inputs["num_cams"]
    config = SlamConfig(num_cameras=2 * num_cams)  # loop closure on: the default
    overrides = dict(max_keypoints=inputs["max_keypoints"], **FULL_PARAMS)
    calibration, traj, frames = inputs["calibration"], inputs["traj"], inputs["frames"]
    ticks = len(frames)
    pipelined = bool(engine_args.get("pipelined"))
    engine = TorchSlamEngine(params=overrides, device=dev, seed=SEED, **FULL_ENGINE_ARGS, **engine_args)
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
    paced = []
    r = _drive(engine, frames, traj, dev,
               on_tick=lambda i: paced.append(engine._light_ctl.adaptive and engine._light_ctl._pace_ok()))
    log, tick_ms, counts_1 = r["log"], r["tick_ms"], r["counts"]
    gt0 = traj.pose(frames[0].timestamp)
    index = {fs.timestamp: i for i, fs in enumerate(frames)}
    if [index[e["ts"]] for e in log] != list(range(ticks)):
        raise AssertionError(f"{label}: ticks finalized out of order or not at all")
    states = [e["state"] for e in log]
    ba_applied = 0
    ba_log = []  # (tick, "rms before->after" where applied, else the gate that refused it)
    skips: dict[str, int] = {}
    est, world, gt = [], [], []
    for i, e in enumerate(log):
        diag = e["diag"]
        ba_applied += "ba_rms" in diag
        if "ba_rms" in diag or "ba_skip" in diag:
            ba_log.append((i, "applied %.5f->%.5f" % diag["ba_rms"] if "ba_rms" in diag else f"skip: {diag['ba_skip']}"))
        for key in ("ba_skip", "loop_skip"):
            if key in diag:
                kind = f"{key}:{str(diag[key]).split()[0].split('=')[0]}"
                skips[kind] = skips.get(kind, 0) + 1
        if e["pose"] is not None and i not in BLACKOUT:
            est.append(e["pose"].position.copy())
            world.append(e["world"].position)
            gt.append((np.linalg.inv(gt0) @ traj.pose(e["ts"]))[:3, 3])
    diag = engine.last_diagnostics
    est, world, gt = np.asarray(est), np.asarray(world), np.asarray(gt)
    imu = engine._imu
    g_true = np.linalg.inv(gt0)[:3, :3] @ GRAVITY_W
    outside = [s for i, s in enumerate(states) if i > 3 and i not in BLACKOUT]
    out = dict(
        render_s=inputs["render_s"],
        tick_ms=tick_ms,
        run_s=r["run_s"],
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
        refreshed=int(sum(bool(e["diag"]["refreshed"]) for e in log)),
        light=[e["light"] for e in log],
        half=[e["half"] for e in log],
        refreshed_on_light=int(sum(bool(e["diag"]["refreshed"]) and e["light"] for e in log)),
        upload_stats=dict(engine.upload_stats),
        paced_calls=int(sum(paced)),
        first_returned=r["returned"][0],
        tail_ts=None if r["tail"] is None else r["tail"].timestamp,
        last_ts=frames[-1].timestamp,
        pipelined=pipelined,
        counts_session1=counts_1,
    )
    print(
        f"{label}: {ticks} ticks, ms per process_frames call median {statistics.median(tick_ms):.3f} p95 "
        f"{float(np.percentile(tick_ms, 95)):.3f} max {max(tick_ms):.3f} (first {tick_ms[0]:.1f}; "
        f"{'not ' if pipelined else ''}synchronized after each call); whole run {r['run_s']:.3f} s, "
        f"{1e3 * r['run_s'] / ticks:.3f} ms a tick"
    )
    print(
        f"{label}: TRACKING on {out['tracking_share']:.1%} of the ticks outside the blackout after tick 3; "
        f"keyframes {out['keyframes']}, loops closed {out['loops_closed']}, BA applied on {ba_applied} "
        f"keyframes; skips {json.dumps(skips)}"
    )
    print(f"{label}: BA by tick {json.dumps(ba_log)}")
    print(f"{label}: closures {json.dumps(closures)}")
    print(
        f"{label}: gravity n={out['gravity_n']} |g|={out['gravity_norm']:.4f} m/s^2, "
        f"{out['gravity_err_deg']:.3f} deg from the truth; accel_pred {out['accel_pred']}, empty IMU windows "
        f"{out['imu_empty_windows']}, gyro bias {diag.get('gyro_bias_rad_s', float('nan')):.5f} rad/s"
    )
    print(
        f"{label}: ATE (unaligned) odometry {out['ate_odom'] * 100:.3f} cm, map-lifted {out['ate_map'] * 100:.3f} cm; "
        f"aligned {out['ate_odom_aligned'] * 100:.3f} / {out['ate_map_aligned'] * 100:.3f} cm; "
        f"end error odometry {out['end_err_odom'] * 100:.3f} cm, map-lifted {out['end_err_map'] * 100:.3f} cm; "
        f"|map_t_odom| {out['map_correction_m'] * 100:.3f} cm"
    )
    print(
        f"{label}: tick types: light {sum(out['light']) / ticks:.1%}, full {1 - sum(out['light']) / ticks:.1%}, "
        f"half-res {sum(out['half']) / ticks:.1%}; upload_stats {json.dumps(out['upload_stats'])}; adaptive controller "
        f"{'on' if engine._light_ctl.adaptive else 'off'}, paced (armed) after {out['paced_calls']} of {ticks} calls, "
        f"degraded: {engine.light_half_active or any(out['half'])}"
    )
    print(f"{label}: session 1 launch counts {json.dumps(counts_1)}")

    if stage_solves:
        out["stage_ms"] = _stage_solves(dev, engine, label, num_cams)
    return _relocalize_session(dev, engine, inputs, out, label, overrides, config, engine_args)


def _stage_solves(dev, engine, label: str, num_cams: int) -> dict:
    """Synchronized times of one solve of each backend stage, on the final
    state; the BA window's solve both eager (on the window moved to the
    card) and graphed (from the engine's pinned window), each with its
    runtime launch and copy calls."""
    from thor_slam_tpu_torch.engine import ba, loop, posegraph

    built = engine._ba.build_problem({})
    problem = ba.BAProblem(*(t.to(dev) for t in built[0])) if built else None
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
        bundle_adjust=sync_ms(dev, lambda: ba.bundle_adjust(problem, huber_delta=0.004)) if built else None,
        bundle_adjust_graphed=sync_ms(dev, lambda: ba.bundle_adjust_graphed(built[0], huber_delta=0.004))
        if built else None,
        find_candidate=sync_ms(dev, lambda: loop.find_candidate(q_desc, q_valid, lb._dev_desc, lb._dev_valid, mask)),
        verify_candidate=sync_ms(dev, lambda: lb._verify(cand_e, cam, obs_norm, q_desc, q_valid, 0)),
        posegraph=sync_ms(dev, lambda: posegraph.optimize(graph)),
    )
    print(
        f"{label}: one solve, synchronized, median of 5 (ms): "
        + ", ".join(f"{k} {v:.3f}" if v is not None else f"{k} not measured" for k, v in stage_ms.items())
        + f" (DB {len(lb.db)} keyframes x {num_cams} cameras, pose graph {graph.poses.shape[0]} nodes)"
    )
    if built:
        calls = dict(bundle_adjust=_runtime_calls(dev, lambda: ba.bundle_adjust(problem, huber_delta=0.004)),
                     bundle_adjust_graphed=_runtime_calls(
                         dev, lambda: ba.bundle_adjust_graphed(built[0], huber_delta=0.004)))
        print(f"{label}: one BA solve's runtime calls {json.dumps(calls)}")
        if calls["bundle_adjust_graphed"]["launches"] > BA_GRAPHED_MAX_LAUNCHES:
            raise AssertionError(f"the graphed BA solve made {calls['bundle_adjust_graphed']['launches']} launches")
    return stage_ms


def _runtime_calls(dev, fn) -> dict:
    """Runtime launch and copy calls of one ``fn()`` under torch.profiler,
    after a warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(dev)
    host = [e.name for e in prof.events() if e.device_type == DeviceType.CPU]
    return dict(launches=sum(n in LAUNCH_CALLS for n in host), copies=sum(n in _COPY_CALLS for n in host))


def _relocalize_session(dev, engine, inputs: dict, out: dict, label: str, overrides, config, engine_args) -> dict:
    """Session 2: save the map, then a fresh engine on a rig whose clocks
    start 1 s later loads it, relocalizes and tracks in its frame."""
    import tempfile

    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine

    gt0 = inputs["traj"].pose(inputs["frames"][0].timestamp)
    cal2, traj2, frames2 = inputs["cal2"], inputs["traj2"], inputs["frames2"]
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/map"
        if not engine.save_map(path):
            raise AssertionError("save_map failed")
        engine.shutdown()
        eng2 = TorchSlamEngine(params=overrides, device=dev, seed=SEED, **FULL_ENGINE_ARGS, **engine_args)
        eng2.initialize(cal2, config)
        if not eng2.load_map(path):
            raise AssertionError("load_map failed")
    attempts = []
    attempt = eng2._loop.relocalize_attempt

    def counted_attempt(*args, **kwargs):
        before = kernel_counts(TRACKER_KERNELS)
        _sync(dev)
        t = time.perf_counter()
        pose = attempt(*args, **kwargs)
        _sync(dev)
        after = kernel_counts(TRACKER_KERNELS)
        attempts.append(dict(
            ok=pose is not None,
            ms=1e3 * (time.perf_counter() - t),
            delta={k: {w: after[k][w] - before[k][w] for w in after[k]} for k in after},
        ))
        return pose

    eng2._loop.relocalize_attempt = counted_attempt
    eng2.relocalize()
    reset_kernel_counts(TRACKER_KERNELS)
    poses = [eng2.process_frames(fs) for fs in frames2]
    poses.append(eng2.flush())
    errs = []
    for pose in poses:
        if pose is not None:
            g_map = np.linalg.inv(gt0) @ traj2.pose(pose.timestamp)
            errs.append(float(np.linalg.norm(pose.position - g_map[:3, 3])))
    out.update(
        reloc_attempts=attempts,
        reloc_ok=not eng2._want_reloc,
        reloc_state=eng2.get_tracking_state(),
        reloc_errs=errs,
        counts_session2=kernel_counts(TRACKER_KERNELS),
    )
    eng2.shutdown()
    print(
        f"{label}: relocalization attempts {json.dumps(attempts)}; state after {RELOC_TICKS} ticks "
        f"{out['reloc_state'].name}; position error in the saved map's frame median "
        f"{np.median(errs) * 100 if errs else float('nan'):.3f} cm (max {max(errs, default=float('nan')) * 100:.3f})"
    )
    print(f"{label}: session 2 launch counts {json.dumps(out['counts_session2'])}")
    return out


def check_full_engine(
    r: dict, kernels: bool = True, label: str = "full-engine", klt_levels: int = 2, want_light: bool = False
) -> dict:
    """The full-engine phase's bars; returns its kernel launches. Session 1
    holds the launch identities (no relocalization runs there); a
    pipelined engine also its latency contract, and light ticks (when the
    engine ships them) never refresh and are counted in ``upload_stats``."""
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
    ticks = len(r["light"])
    _check_counts(f"{label} session 1", dict(tick_ms=r["tick_ms"], keyframes=r["refreshed"], counts=r["counts_session1"]),
                  klt_levels, failures, kernels)
    need(not want_light or sum(r["light"]) > 0, "no light tick")
    stats = r["upload_stats"]
    need(stats["full"] + stats["light"] + stats["light_half"] == ticks, f"upload_stats {stats} over {ticks} ticks")
    need(stats["light"] + stats["light_half"] == sum(r["light"]), f"upload_stats {stats}: not {sum(r['light'])} light ticks")
    need(r["refreshed_on_light"] == 0, f"{r['refreshed_on_light']} light ticks refreshed")
    if r["pipelined"]:
        need(r["first_returned"] is None, "the first call of a pipelined engine returned a pose")
        need(r["tail_ts"] == r["last_ts"], f"flush() returned the pose of {r['tail_ts']}, not of the last tick {r['last_ts']}")
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
        raise AssertionError(f"{label} phase: " + "; ".join(failures))
    return launches


def _drive(engine, frames, traj, dev, on_tick=None) -> dict:
    """Drive ``engine`` over ``frames`` with the gather and FAST counts
    set to 0 just before and read just after the flush. Each call is timed
    on the host's clock, the device synchronized after it only when the
    engine is synchronous (it would undo a pipelined engine's overlap);
    ``on_tick(i)`` runs after call i. Poses, states and keyframes are read
    from every finalized tick (``log_finalized``): one call of a pipelined
    engine may finalize several."""
    from thor_slam_tpu_torch.slam.interface import TrackingState

    log = log_finalized(engine)
    _sync(dev)
    reset_kernel_counts(TRACKER_KERNELS)
    gt0 = traj.pose(frames[0].timestamp)
    tick_ms, returned = [], []
    t_run = time.perf_counter()
    for i, fs in enumerate(frames):
        t = time.perf_counter()
        returned.append(engine.process_frames(fs))
        if not engine._pipelined:
            _sync(dev)
        tick_ms.append(1e3 * (time.perf_counter() - t))
        if on_tick is not None:
            on_tick(i)
    tail = engine.flush()
    _sync(dev)
    run_s = time.perf_counter() - t_run
    poses = [e["pose"] for e in log]
    states = [e["state"] for e in log]
    first = next((i for i, s in enumerate(states) if s == TrackingState.TRACKING), None)
    return dict(
        log=log, returned=returned, tail=tail, tick_ms=tick_ms, run_s=run_s, counts=kernel_counts(TRACKER_KERNELS),
        poses=poses,
        keyframes=int(sum(bool(e["diag"]["refreshed"]) for e in log)), states=states,
        est=np.asarray([p.position for p in poses if p is not None]),
        gt=np.asarray([(np.linalg.inv(gt0) @ traj.pose(p.timestamp))[:3, 3] for p in poses if p is not None]),
        first_tracking=first,
        held=float(np.mean([s == TrackingState.TRACKING for s in states[first:]])) if first is not None else 0.0,
    )


def _check_counts(name: str, r: dict, klt_levels: int, failures: list, kernels: bool = True, shards: int = 1) -> dict:
    """One gather launch per KLT level and tick plus one per keyframe, one
    FAST launch per keyframe (both eyes of every camera, a mono camera's
    zero-filled right image included), no plain call; each ``shards``
    times on a mesh (every shard makes its own launches). (``kernels=False``,
    a rehearsal on the CPU: the same counts of the plain versions.)"""
    ticks, keyframes, counts = len(r["tick_ms"]), r["keyframes"], r["counts"]
    ran, other = ("kernel", "plain") if kernels else ("plain", "kernel")
    want = shards * (klt_levels * ticks + keyframes)
    if counts["patch_gather"][ran] != want:
        failures.append(f"{name}: patch gather launched {counts['patch_gather'][ran]}, not {shards} x "
                        f"({klt_levels} x {ticks} + {keyframes})")
    if counts["fast9_nms"][ran] != shards * keyframes or keyframes == 0:
        failures.append(f"{name}: FAST launched {counts['fast9_nms'][ran]} for {keyframes} keyframes on {shards} shard(s)")
    if any(c[other] for c in counts.values()):
        failures.append(f"{name}: {other} versions ran: {counts}")
    return {k: c[ran] for k, c in counts.items()}


def check_on_rig_frames(
    dev, label: str, frames, calibration, max_keypoints: int, kernels: bool = True, cams: slice = slice(None)
) -> None:
    """Both kernels against their plain versions on a rig's own frames, at
    the shapes the rig's ticks give them: FAST on the (2C, H, W) view of one
    frame set (a mono camera's right image zero), the pair gather on the
    left images of two consecutive frame sets (a KLT level, S = 19) and on
    the two eyes of one (BRIEF, S = 37, strided), with ``max_keypoints``
    centres a camera around the strongest corners and past the borders.
    ``cams`` takes a camera shard's part of the frame sets. Runs before the
    phase's counts are set to 0."""
    from thor_slam_tpu_torch.engine import staging
    from thor_slam_tpu_torch.ops import fast_cuda, patches_cuda

    if not kernels:
        return
    order = sorted(calibration.source_names)
    zero = np.zeros_like(frames[0].frame_sets[order[0]].frames[0].image)
    a, b = (torch.from_numpy(staging.stage_images(fs, order, zero)[cams]).to(dev).float() * (1.0 / 255.0)
            for fs in frames[:2])
    c, _, h, w = a.shape
    raw_k, nms_k = fast_cuda.fast_scores_cuda(a.reshape(2 * c, h, w), 0.05)
    raw_p, nms_p = fast_cuda.fast_scores_plain(a.reshape(2 * c, h, w), 0.05)
    err = max(float((raw_k - raw_p).abs().max()), float((nms_k - nms_p).abs().max()))
    if not err <= 1e-6:
        raise AssertionError(f"{label}: FAST differs from its plain version by {err} on the rig's frames")
    # Centres: each camera's strongest NMS peaks of the left image, every
    # fourth pushed 30 px outwards so that windows are clipped at the borders.
    top = nms_k.reshape(c, 2, h * w)[:, 0].topk(max_keypoints, dim=1).indices
    xy = torch.stack([top % w, top // w], -1).reshape(c * max_keypoints, 2).to(torch.int32)
    xy[::4] = (xy[::4] - torch.tensor([w // 2, h // 2], device=dev, dtype=torch.int32)) * 2 + xy[::4]
    centers = torch.stack([xy, xy + 3])
    cam = torch.arange(c, dtype=torch.int32, device=dev).repeat_interleave(max_keypoints)
    for what, stacks, size in (("KLT level", (a[:, 0].contiguous(), b[:, 0].contiguous()), 19), ("BRIEF", (a[:, 0], a[:, 1]), 37)):
        got, clipped = patches_cuda.extract_patches_pair_cuda(*stacks, cam, centers, size)
        want = torch.stack([patches_cuda.extract_patches_flat_plain(s, cam, k, size) for s, k in zip(stacks, centers)])
        r = size // 2
        clamps = torch.stack([torch.clamp(centers[..., 0], r, w - r - 1), torch.clamp(centers[..., 1], r, h - r - 1)], -1)
        if not torch.equal(got, want) or not torch.equal(clipped, clamps):
            raise AssertionError(f"{label}: the pair gather ({what}) differs from its plain version on the rig's frames")
    _sync(dev)
    print(
        f"{label}: kernels on the rig's own frames: fast9_nms C,H,W={2 * c},{h},{w} max_abs_err={err} "
        f"corners={int((raw_k > 0).sum())}; patch_gather pair C={c} M=2x{c * max_keypoints} S=19 and S=37 (eyes, strided): exact"
    )


def render_mono_inputs(width=640, height=400, max_keypoints=512, pool=None) -> dict:
    """The frame sets of the mixed and the all-mono rig."""
    return start_mono_inputs(width, height, max_keypoints, pool)()


def start_mono_inputs(width=640, height=400, max_keypoints=512, pool=None):
    """Start rendering the mixed and the all-mono rig's frames in the pool;
    returns a function that waits for them and gives ``render_mono_inputs``'s
    result (render_s: the wait)."""
    from thor_slam_tpu_torch.camera.rig import CameraRig
    from thor_slam_tpu_torch.utils.flagship import flagship_rig, mono_rig

    # Mixed: 4 stereo + 1 mono (the last in name order), as the slice is driven.
    params, _, mixed_cal, mixed_sources, _, mixed_traj = flagship_rig(
        4, width, height, max_keypoints, mono_yaws=(MIXED_MONO_YAW,)
    )
    # All-mono: two cameras, the IMU of source 0 (gyro prediction only).
    mono_cal, mono_sources, mono_traj = mono_rig(2, width, height)
    delivers = [submit_renders(pool, mixed_sources, MIXED_TICKS), submit_renders(pool, mono_sources, MONO_TICKS)]

    def finish() -> dict:
        t0 = time.perf_counter()
        for deliver in delivers:
            deliver()
        with CameraRig(mixed_sources, rig_extrinsics=mixed_cal.rig_extrinsics) as rig:
            frames = [rig.get_synchronized_frames() for _ in range(MIXED_TICKS)]
        mixed = dict(klt_levels=params.klt_levels, calibration=mixed_cal, traj=mixed_traj, frames=frames)
        with CameraRig(mono_sources, rig_extrinsics=mono_cal.rig_extrinsics, imu_source=mono_sources[0].name) as rig:
            frames = [rig.get_synchronized_frames() for _ in range(MONO_TICKS)]
        render_s = time.perf_counter() - t0
        return dict(mixed=dict(mixed, render_s=render_s),
                    mono=dict(calibration=mono_cal, traj=mono_traj, frames=frames, render_s=render_s))

    return finish


def run_mono_phases(dev, reuse: dict, inputs: dict, max_keypoints=512, kernels: bool = True) -> dict:
    """The mixed rig, the all-mono rig and the two front-end switches at
    full width, on the frame sets of ``render_mono_inputs``; returns their
    gather and FAST launches. (Smaller inputs with ``kernels=False``
    rehearse the phase on the CPU.)"""
    from thor_slam_tpu_torch.engine import tracker as trk
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
    from thor_slam_tpu_torch.slam.interface import SlamConfig, TrackingState
    from thor_slam_tpu_torch.utils.evaluation import ate_rmse

    failures: list[str] = []
    launches = {"patch_gather": 0, "fast9_nms": 0}

    def add(counts):
        for k, n in counts.items():
            launches[k] += n

    klt_levels, calibration, traj, frames, render_s = (
        inputs["mixed"][k] for k in ("klt_levels", "calibration", "traj", "frames", "render_s")
    )
    check_on_rig_frames(dev, "mixed", frames, calibration, max_keypoints, kernels)
    engine = TorchSlamEngine(params=dict(max_keypoints=max_keypoints), device=dev, seed=SEED, **PR6_MODES)
    engine.initialize(calibration, SlamConfig(num_cameras=9, enable_loop_closure=False))
    r = _drive(engine, frames, traj, dev)
    state = engine._tracker_state
    bank = state.lm_valid.sum(1).tolist()
    seeded_w = state.lm_weight[-1][state.lm_valid[-1]]
    ate = ate_rmse(r["est"], r["gt"])
    print(
        f"mixed: {MIXED_TICKS} ticks of 4 stereo + 1 mono camera at yaw {MIXED_MONO_YAW:.3f} rad (rendered in "
        f"{render_s:.1f} s), median ms/tick {statistics.median(r['tick_ms']):.3f}, keyframes {r['keyframes']}, ATE "
        f"{ate * 100:.3f} cm, TRACKING from tick {r['first_tracking']} on {r['held']:.1%} of the ticks after; valid slots per "
        f"camera {bank} (mono last), its weights median {float(seeded_w.median()) if len(seeded_w) else float('nan'):.4f}; "
        f"BA applied: {'ba_rms' in engine.last_diagnostics}; launch counts {json.dumps(r['counts'])}"
    )
    if r["first_tracking"] is None or r["first_tracking"] > 3 or r["held"] < 0.9:
        failures.append(f"mixed: TRACKING from {r['first_tracking']}, held {r['held']:.0%}")
    if not ate < 0.05:
        failures.append(f"mixed: ATE {ate:.4f} m >= 0.05 m")
    if not bank[-1] > MIN_SEEDED or not bool(((seeded_w > 0) & (seeded_w < 1)).all()):
        failures.append(f"mixed: the mono camera's bank holds {bank[-1]} slots, weights {seeded_w.tolist()[:5]}")
    add(_check_counts("mixed", r, klt_levels, failures, kernels))
    engine.shutdown()

    calibration, traj, frames, render_s = (inputs["mono"][k] for k in ("calibration", "traj", "frames", "render_s"))
    check_on_rig_frames(dev, "all-mono", frames, calibration, max_keypoints, kernels)
    engine = TorchSlamEngine(params=dict(max_keypoints=max_keypoints, **MONO_PARAMS), device=dev, seed=SEED, **PR6_MODES)
    engine.initialize(calibration, SlamConfig(num_cameras=2, enable_loop_closure=False))
    attempts, boot, promoted = [], {}, []

    def on_tick(i):
        attempt = engine.last_diagnostics.get("mono_bootstrap")
        if attempt is not None:
            attempts.append(attempt)
            if attempt["success"]:
                boot.setdefault("at", i)
        state = engine._tracker_state
        promoted.append((state.lm_valid & ~state.lm_pending).sum(1).tolist())

    r = _drive(engine, frames, traj, dev, on_tick)
    # One more attempt, warm, on the run's last state (the same fixed-shape work on other tracks).
    warm_ms = sync_ms(dev, lambda: trk.mono_init(
        engine._params, engine._setup, engine._tracker_state, generator=torch.Generator(device=dev).manual_seed(SEED)
    ))
    real = promoted[-1]
    since_boot = np.asarray(promoted[boot.get("at", 0):])
    tail = np.median(np.asarray(promoted[-MONO_TAIL_TICKS:]), axis=0)
    held = float(np.mean([s == TrackingState.TRACKING for s in r["states"][boot.get("at", 0) + 1:]]))
    n = len(r["est"])
    ate = ate_rmse(r["est"][n // 2 :], r["gt"][n // 2 :], with_scale=True)
    path = float(np.linalg.norm(np.diff(r["gt"][n // 2 :], axis=0), axis=1).sum())
    print(
        f"all-mono: {MONO_TICKS} ticks of 2 mono cameras (rendered in {render_s:.1f} s), median ms/tick "
        f"{statistics.median(r['tick_ms']):.3f}, keyframes {r['keyframes']}; bootstrap at tick {boot.get('at')} after "
        f"{len(attempts)} attempts: {json.dumps(attempts)} (ms on the host's clock, the first with the eigensolver's "
        f"set-up; one more on the last state, warm, median of 5: {warm_ms:.3f} ms); promoted landmarks per camera "
        f"at the end {real}, median over the last {MONO_TAIL_TICKS} ticks {tail.tolist()}, since the bootstrap min "
        f"{since_boot.min(0).tolist()} median {np.median(since_boot, 0).tolist()} max {since_boot.max(0).tolist()}; TRACKING on "
        f"{held:.1%} of the ticks after it; "
        f"Sim(3)-aligned ATE over the second half {ate * 100:.3f} cm of a {path * 100:.1f} cm path ({ate / max(path, 0.1):.1%}); "
        f"state {r['states'][-1].name}; BA {engine._enable_ba}, accel {engine._use_accel}; launch counts {json.dumps(r['counts'])}"
    )
    print(f"all-mono: promoted landmarks per camera by tick {json.dumps(promoted)}")
    if boot.get("at") is None or not boot["at"] < MONO_BOOT_BY:
        failures.append(f"all-mono: bootstrap at tick {boot.get('at')}, not before {MONO_BOOT_BY}")
    if r["states"][-1] != TrackingState.TRACKING or held < 0.9:
        failures.append(f"all-mono: state {r['states'][-1].name} at the end, TRACKING on {held:.0%} of the ticks after the bootstrap")
    if not all(level > need for level, need in zip(tail, MONO_MIN_LANDMARKS)) or min(real) == 0:
        failures.append(
            f"all-mono: promoted landmarks over the last {MONO_TAIL_TICKS} ticks median {tail.tolist()}, need more than "
            f"{MONO_MIN_LANDMARKS}; at the end {real}"
        )
    if not ate < MONO_MAX_ATE_SHARE * max(path, 0.1):
        failures.append(f"all-mono: scale-aligned ATE {ate:.3f} m over {path:.2f} m")
    if engine._enable_ba or engine._use_accel:
        failures.append("all-mono: BA or the accel term stayed on")
    add(_check_counts("all-mono", r, klt_levels, failures, kernels))
    engine.shutdown()

    # The two switches on the slice's first ticks.
    overrides = dict(max_keypoints=reuse["max_keypoints"], median_prefilter=True, oriented_descriptors=True)
    engine = TorchSlamEngine(params=overrides, device=dev, seed=SEED, **PR6_MODES)
    engine.initialize(reuse["calibration"], SlamConfig(num_cameras=8, enable_loop_closure=False))
    r = _drive(engine, reuse["frames"], reuse["traj"], dev)
    ate = ate_rmse(r["est"], r["gt"])
    print(
        f"switches: {SWITCH_TICKS} ticks of the slice with median_prefilter and oriented_descriptors: median ms/tick "
        f"{statistics.median(r['tick_ms']):.3f} (the plain slice's same ticks: {statistics.median(reuse['tick_ms']):.3f}), "
        f"keyframes {r['keyframes']}, ATE {ate * 100:.3f} cm, state {r['states'][-1].name}; launch counts {json.dumps(r['counts'])}"
    )
    if not ate < 0.05 or r["states"][-1] != TrackingState.TRACKING:
        failures.append(f"switches: ATE {ate:.4f} m, state {r['states'][-1].name}")
    add(_check_counts("switches", r, klt_levels, failures, kernels))
    engine.shutdown()
    if failures:
        raise AssertionError("mono phases: " + "; ".join(failures))
    return launches


def _ms_line(r) -> str:
    ms = r["tick_ms"]
    return (f"ms per call median {statistics.median(ms):.3f} p95 {float(np.percentile(ms, 95)):.3f} max {max(ms):.3f}, "
            f"{1e3 * r['run_s'] / len(ms):.3f} ms a tick over the run")


def with_imu(frames, traj, rate_hz: float = 400.0) -> list:
    """The frame sets with the IMU packets of source 0 added, as a synthetic
    source delivers them (``camera/sources/synthetic.py``): every sample of
    the trajectory from the last packet up to the tick's timestamp. No
    image is rendered again."""
    import dataclasses

    out, n0 = [], 0
    for fs in frames:
        n1 = int(np.floor(fs.timestamp * rate_hz))
        ticks = np.arange(n0, n1)
        n0 = max(n0, n1)
        if len(ticks) == 0:
            out.append(fs)
            continue
        ts = ticks / rate_hz
        samples = [traj.imu_sample(float(t)) for t in ts]
        data = dict(accelerometer=np.stack([a for _, a in samples]), gyroscope=np.stack([g for g, _ in samples]),
                    timestamps=ts, timestamp=float(ts[-1]), sequence_num=int(ticks[-1]))
        out.append(dataclasses.replace(fs, sensor_data=data, sensor_timestamp=float(ts[-1])))
    return out


def run_deep(dev, inputs: dict, reuse: dict, kernels: bool = True) -> dict:
    """The engine with BA, the IMU and loop closure at pipeline depth 1 and
    DEEP_DEPTH (adaptive half-res off, so the two runs ship alike), on two
    sequences. The slice's frame sets with the IMU packets of source 0
    (``with_imu``) are held to the bars of tests/test_engine_pipeline_deep.py.
    The first DEEP_TICKS of the full-engine render start moving at 1 rad/s
    on their first tick (see DEEP_DEPTH): there every bar but the ATE's is
    held, and both ATEs are printed. Returns the runs' launches."""
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
    from thor_slam_tpu_torch.slam.interface import SlamConfig
    from thor_slam_tpu_torch.utils.evaluation import ate_rmse

    failures: list[str] = []
    launches = {"patch_gather": 0, "fast9_nms": 0}
    sequences = [
        ("slice + IMU", with_imu(reuse["all_frames"], reuse["traj"]), reuse["traj"], reuse["calibration"],
         dict(max_keypoints=reuse["max_keypoints"]), {}, True),
        ("full render, flying start", inputs["frames"][:DEEP_TICKS], inputs["traj"], inputs["calibration"],
         dict(max_keypoints=inputs["max_keypoints"], **FULL_PARAMS), FULL_ENGINE_ARGS, False),
    ]
    for name, frames, traj, calibration, params, engine_args, ate_bar in sequences:
        out = {}
        for depth in (1, DEEP_DEPTH):
            engine = TorchSlamEngine(params=params, device=dev, seed=SEED, pipelined=True, pipeline_depth=depth,
                                     adaptive_half_res=False, **engine_args)
            engine.initialize(calibration, SlamConfig(num_cameras=2 * len(calibration.source_names)))
            r = _drive(engine, frames, traj, dev)
            solved = sum(
                "ba_rms" in e["diag"] or not str(e["diag"].get("ba_skip", "window")).startswith(("window", "joined"))
                for e in r["log"]
            )
            r.update(solved=solved, empty=engine.imu_empty_windows, ate=ate_rmse(r["est"], r["gt"]),
                     loop=engine._config.enable_loop_closure, light=sum(e["light"] for e in r["log"]),
                     pred_err=[e["diag"].get("imu_pred_err_m") for e in r["log"]])
            print(
                f"deep: {name}, depth {depth}, {len(frames)} ticks (BA, IMU, loop closure), {_ms_line(r)}; first calls "
                f"returned {[p is not None for p in r['returned'][:depth + 1]]}; BA solved {solved}, empty IMU "
                f"windows {r['empty']}, keyframes {r['keyframes']}, light ticks {r['light']}, inliers of the first "
                f"ticks {[e['diag']['num_inliers'] for e in r['log'][:6]]}, ATE {r['ate'] * 100:.3f} cm; launch "
                f"counts {json.dumps(r['counts'])}"
            )
            for k, n in _check_counts(f"deep ({name}, depth {depth})", r, 2, failures, kernels).items():
                launches[k] += n
            out[depth] = r
            engine.shutdown()
        d1, dn = out[1], out[DEEP_DEPTH]
        if not (d1["solved"] >= 1 and dn["solved"] >= 1):
            failures.append(f"deep ({name}): BA solved {d1['solved']} / {dn['solved']} times")
        if not (d1["empty"] <= 2 and dn["empty"] <= 2) or not any(e is not None for e in dn["pred_err"]):
            failures.append(f"deep ({name}): empty IMU windows {d1['empty']} / {dn['empty']}, or no prediction")
        if not all(p is None for p in dn["returned"][:DEEP_DEPTH]) or not dn["loop"]:
            failures.append(f"deep ({name}): the first {DEEP_DEPTH} calls returned {dn['returned'][:DEEP_DEPTH]}")
        if ate_bar and not dn["ate"] < 1.5 * d1["ate"] + 0.02:
            failures.append(f"deep ({name}): ATE at depth {DEEP_DEPTH} {dn['ate']:.4f} m against {d1['ate']:.4f} m")
    if failures:
        raise AssertionError("deep phase: " + "; ".join(failures))
    return launches


def run_defer_sync(dev, reuse: dict, kernels: bool = True) -> dict:
    """The slice's first MODE_TICKS frames, VO only (BA and the IMU off),
    synchronous and under ``defer_sync``: every deferred call returns None, the flush gives
    one pose a tick, and the ATE is the synchronous run's within
    MAX_DEFER_ATE_DIFF_M. Returns both runs' launches."""
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
    from thor_slam_tpu_torch.slam.interface import SlamConfig
    from thor_slam_tpu_torch.utils.evaluation import ate_rmse

    failures: list[str] = []
    launches = {"patch_gather": 0, "fast9_nms": 0}
    frames, traj = reuse["all_frames"][:MODE_TICKS], reuse["traj"]
    runs = {}
    for name, modes in (("synchronous", dict(light_ticks=False)), ("defer_sync", dict(pipelined=True, defer_sync=True))):
        engine = TorchSlamEngine(params=dict(max_keypoints=reuse["max_keypoints"]), device=dev, seed=SEED,
                                 enable_ba=False, use_imu=False, **modes)
        engine.initialize(reuse["calibration"], SlamConfig(num_cameras=8, enable_loop_closure=False))
        r = _drive(engine, frames, traj, dev)
        r.update(ate=ate_rmse(r["est"], r["gt"]), flushed=list(engine.last_flush_poses))
        print(f"defer_sync: {name}, {len(frames)} ticks (VO), {_ms_line(r)}; ATE {r['ate'] * 100:.4f} cm; "
              f"keyframes {r['keyframes']}; launch counts {json.dumps(r['counts'])}")
        for k, n in _check_counts(f"defer_sync ({name})", r, reuse["klt_levels"], failures, kernels).items():
            launches[k] += n
        runs[name] = r
        engine.shutdown()
    sync, defer = runs["synchronous"], runs["defer_sync"]
    diff = max(
        (float(np.linalg.norm(a.position - b.position)) for a, b in zip(sync["returned"], defer["flushed"])
         if a is not None and b is not None),
        default=float("nan"),
    )
    print(f"defer_sync: largest per-tick position difference from the synchronous run {diff:.3e} m, "
          f"ATE difference {abs(defer['ate'] - sync['ate']) * 100:.6f} cm")
    if not all(p is None for p in defer["returned"]):
        failures.append("defer_sync: a call returned a pose before the flush")
    if len(defer["flushed"]) != len(frames) or defer["tail"] is not defer["flushed"][-1]:
        failures.append(f"defer_sync: {len(defer['flushed'])} flushed poses for {len(frames)} ticks")
    if not abs(defer["ate"] - sync["ate"]) < MAX_DEFER_ATE_DIFF_M:
        failures.append(f"defer_sync: ATE {defer['ate']:.6f} m against the synchronous {sync['ate']:.6f} m")
    if failures:
        raise AssertionError("defer_sync phase: " + "; ".join(failures))
    return launches


def run_half(dev, reuse: dict, kernels: bool = True) -> dict:
    """The slice's first MODE_TICKS frames with half-resolution light ticks
    (the slice's engine otherwise): half-res light ticks run and the ATE stays under 5
    cm. Then the deployed engine with the adaptive controller told the
    stream is paced (``pace_override``: a rig that drops frames): the tick
    on which it degraded, if any, and its busy EMA are printed, no bar (the
    outcome depends on the host). Returns both runs' launches."""
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
    from thor_slam_tpu_torch.slam.interface import SlamConfig
    from thor_slam_tpu_torch.utils.evaluation import ate_rmse

    failures: list[str] = []
    launches = {"patch_gather": 0, "fast9_nms": 0}
    frames, traj = reuse["all_frames"][:MODE_TICKS], reuse["traj"]
    config = SlamConfig(num_cameras=8, enable_loop_closure=False)
    engine = TorchSlamEngine(params=dict(max_keypoints=reuse["max_keypoints"]), device=dev, seed=SEED,
                             light_ticks=True, light_half_res=True)
    engine.initialize(reuse["calibration"], config)
    r = _drive(engine, frames, traj, dev)
    halves = sum(e["half"] and e["light"] for e in r["log"])
    ate = ate_rmse(r["est"], r["gt"])
    print(f"half: {len(frames)} ticks, light_half_res, {_ms_line(r)}; half-res light ticks {halves}, keyframes "
          f"{r['keyframes']}, ATE {ate * 100:.3f} cm (the slice's {reuse['ate'] * 100:.3f}); upload_stats "
          f"{json.dumps(engine.upload_stats)}; launch counts {json.dumps(r['counts'])}")
    if not halves > 0 or not ate < 0.05:
        failures.append(f"half: {halves} half-res light ticks, ATE {ate:.4f} m")
    for k, n in _check_counts("half", r, reuse["klt_levels"], failures, kernels).items():
        launches[k] += n
    engine.shutdown()

    engine = TorchSlamEngine(params=dict(max_keypoints=reuse["max_keypoints"]), device=dev, seed=SEED, **DEPLOYED_MODES)
    engine.initialize(reuse["calibration"], config)
    ctl = engine._light_ctl
    ctl.pace_override = True
    degraded_at, emas = [None], []
    step = engine._light_ctl.on_tick

    def on_tick(busy_s, frame_ts, now_wall):
        step(busy_s, frame_ts, now_wall)
        emas.append(ctl._busy_ema)
        if ctl.half_active and degraded_at[0] is None:
            degraded_at[0] = len(emas) - 1

    ctl.on_tick = on_tick
    r = _drive(engine, frames, traj, dev)
    ate = ate_rmse(r["est"], r["gt"])
    print(f"half: adaptive (deployed engine, pace_override), {_ms_line(r)}; degraded on call {degraded_at[0]} "
          f"(budget {1e3 * ctl.budget_s:.1f} ms, degrade above {0.92e3 * ctl.budget_s:.1f} ms); busy EMA by call "
          f"{json.dumps([round(1e3 * e, 3) for e in emas])} ms; half-res light ticks "
          f"{sum(e['half'] and e['light'] for e in r['log'])}, ATE {ate * 100:.3f} cm; upload_stats "
          f"{json.dumps(engine.upload_stats)}")
    for k, n in _check_counts("half (adaptive)", r, reuse["klt_levels"], failures, kernels).items():
        launches[k] += n
    engine.shutdown()
    if failures:
        raise AssertionError("half phase: " + "; ".join(failures))
    return launches


_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def _profiled_spans(prof, names):
    """The host ranges ``phase:<name>`` of a torch.profiler run, by name, and
    a function that counts the synchronizing runtime calls (_SYNC_CALLS)
    that start inside a range."""
    from torch.autograd import DeviceType

    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    spans = {name: sorted((e.time_range.start, e.time_range.end) for e in host if e.name == f"phase:{name}")
             for name in names}
    stamps = np.sort(np.asarray([e.time_range.start for e in host if e.name in _SYNC_CALLS], np.float64))

    def inside(span) -> int:
        return int(np.searchsorted(stamps, span[1], "right") - np.searchsorted(stamps, span[0], "left"))

    return spans, inside


def sync_calls_by_tick_type(dev, inputs: dict) -> dict:
    """Synchronizing runtime calls of the deployed engine by tick type (the
    ``--tick-launches`` recipe): SYNC_PROFILE_TICKS calls after warm-up
    under torch.profiler, each call and each ``track_step`` in a named
    range; the calls that stop the host (cudaStreamSynchronize,
    cudaDeviceSynchronize, cudaEventSynchronize) counted inside each.
    A call's tick type is that of the tick it dispatched: light, full
    (no keyframe) or keyframe; the call also finalizes the tick before."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from thor_slam_tpu_torch.engine import tracker as trk
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
    from thor_slam_tpu_torch.slam.interface import SlamConfig

    engine = TorchSlamEngine(params=dict(max_keypoints=inputs["max_keypoints"], **FULL_PARAMS), device=dev, seed=SEED,
                             **FULL_ENGINE_ARGS, **DEPLOYED_MODES)
    engine.initialize(inputs["calibration"], SlamConfig(num_cameras=2 * inputs["num_cams"]))
    frames = inputs["frames"][: WARMUP_TICKS + SYNC_PROFILE_TICKS]
    for fs in frames[:WARMUP_TICKS]:
        engine.process_frames(fs)
    kinds = []
    step = trk.track_step_graphed  # the engine's tick

    def ranged_step(*args, **kwargs):
        with record_function("phase:track_step"):
            state, out = step(*args, **kwargs)
        kinds.append("light" if not kwargs.get("allow_refresh", True) else "keyframe" if out.refreshed_host else "full")
        return state, out

    trk.track_step_graphed = ranged_step
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for fs in frames[WARMUP_TICKS:]:
                with record_function("phase:call"):
                    engine.process_frames(fs)
    finally:
        trk.track_step_graphed = step
    engine.flush()
    engine.shutdown()
    spans, inside = _profiled_spans(prof, ("call", "track_step"))
    if len(spans["call"]) != SYNC_PROFILE_TICKS or len(kinds) != SYNC_PROFILE_TICKS:
        raise AssertionError(f"{len(spans['call'])} call ranges and {len(kinds)} steps, not {SYNC_PROFILE_TICKS}")
    rows: dict[str, list] = {}
    for kind, call in zip(kinds, spans["call"]):
        steps = [s for s in spans["track_step"] if call[0] <= s[0] <= call[1]]
        rows.setdefault(kind, []).append((inside(call), sum(inside(s) for s in steps)))
    out = {
        kind: dict(n=len(v), per_call=statistics.median(a for a, _ in v), in_track_step=statistics.median(b for _, b in v),
                   per_call_max=max(a for a, _ in v))
        for kind, v in sorted(rows.items())
    }
    print(f"deployed: synchronizing runtime calls by tick type (medians over {SYNC_PROFILE_TICKS} profiled calls; "
          f"{', '.join(_SYNC_CALLS)}): {json.dumps(out)}")
    return out


def _event_ms(dev, fn) -> tuple[float, float]:
    """(host ms of ``fn()`` without a synchronization, device ms between two
    CUDA events around it); on the CPU both are the host's clock."""
    if dev.type != "cuda":
        t = time.perf_counter()
        fn()
        ms = 1e3 * (time.perf_counter() - t)
        return ms, ms
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t = time.perf_counter()
    fn()
    host_ms = 1e3 * (time.perf_counter() - t)
    end.record()
    end.synchronize()
    return host_ms, start.elapsed_time(end)


def _truth_mm(depth_m: np.ndarray) -> np.ndarray:
    """The renderer's true depth in the product's encoding (u16 mm, 0 invalid)."""
    mm = np.round(np.nan_to_num(depth_m, nan=0.0, posinf=0.0) * 1000.0)
    return np.where((mm > 0) & (mm <= 65535), mm, 0).astype(np.uint16)


def render_mapping_inputs(dev, width=320, height=200, color_resolution=(640, 400), ticks=10) -> dict:
    """The mapping phase's inputs without the slice (a CPU rehearsal): one
    camera of the flagship rig, an RGB-D frame every RGBD_EVERY ticks at the
    true body poses relative to the first tick."""
    from thor_slam_tpu_torch.camera.rig import CameraRig
    from thor_slam_tpu_torch.pipeline import RGBDProcessor
    from thor_slam_tpu_torch.utils.flagship import flagship_rig

    _, _, calibration, sources, _, traj = flagship_rig(1, width, height, 64, color_resolution=color_resolution)
    src = sources[0]
    processor = RGBDProcessor(src.name, src.get_intrinsics(), src.get_extrinsics(), num_disparities=RGBD_DISPARITIES,
                              color_intrinsics=src.get_rgb_intrinsics(),
                              left_t_color=src.get_rgb_extrinsics().to_4x4_matrix(), device=dev)
    items = []
    with CameraRig(sources, rig_extrinsics=calibration.rig_extrinsics) as rig:
        for i in range(ticks):
            fs = rig.get_synchronized_frames()
            if (i + 1) % RGBD_EVERY == 0:
                color = src.try_get_latest_rgb_frame()
                gt0 = traj.pose(0.0)
                items.append(dict(tick=i, frame_set=fs, color=color, truth=src.render_color_depth(color.sequence_num),
                                  world_t_body=np.linalg.inv(gt0) @ traj.pose(fs.timestamp)))
    return dict(processor=processor, rgbd_items=items,
                body_t_left=calibration.get_world_extrinsics(src.name)[0].to_4x4_matrix())


def run_mapping(dev, reuse: dict, scan_launches: int, config=None, kernels: bool = True) -> dict:
    """Dense mapping at the deployed grid (``MapperConfig()``) on the slice's
    RGB-D frames: each product made with ``fetch=False`` and integrated by a
    ``DenseMapper`` on the card at the engine's pose composed with the
    product's frame, as ``run_pipeline`` does. Times each integrate (host,
    unsynchronized, and device, between CUDA events), the bulk integrator,
    decay, one forced recenter, the surface cloud, the mesh and the costmap
    slice; counts the synchronizing runtime calls of each integrate under
    torch.profiler (must be 0); holds the SGM launch identity of the mapped
    frames, and the grid against one integrated from the renderer's true
    depth at the same poses. Returns the SGM launches."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from thor_slam_tpu_torch.mapping import TsdfGrid, make_decay, make_grid, make_recenter, make_scan_integrator
    from thor_slam_tpu_torch.ops import sgm_cuda
    from thor_slam_tpu_torch.pipeline import RGBDFrame
    from thor_slam_tpu_torch.pipeline.mapper import DenseMapper, MapperConfig

    config = config or MapperConfig()
    processor, items = reuse["processor"], reuse["rgbd_items"]
    product_ext = reuse["body_t_left"] @ processor.product_t_in_left
    poses = [item["world_t_body"] @ product_ext for item in items]
    failures: list[str] = []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _sync(dev)
    sgm_cuda.reset_counts()
    frames = [processor.process(it["frame_set"], color_frame=it["color"], fetch=False) for it in items]
    _sync(dev)
    counts = {name: dict(c) for name, c in sgm_cuda.counts.items()}
    ran, other = ("kernel", "plain") if kernels else ("plain", "kernel")
    if counts["sgm_scan"][ran] != scan_launches * len(frames) or counts["sgm_winner_lr"][ran] < len(frames):
        failures.append(f"SGM launches {counts} for {len(frames)} frames, not {scan_launches} scan launches each")
    if any(c[other] for c in counts.values()):
        failures.append(f"{other} SGM versions ran: {counts}")

    mapper = DenseMapper(config, device=dev)
    host_ms, device_ms_ = [], []
    for frame, pose in zip(frames, poses):
        h, d = _event_ms(dev, lambda: mapper.integrate(frame, pose))
        host_ms.append(h)
        device_ms_.append(d)
    spec, grid = mapper.spec, mapper.grid
    grid_bytes = sum(t.numel() * t.element_size() for t in grid)
    depth_bytes = frames[0].depth_mm.numel() * frames[0].depth_mm.element_size()
    color_bytes = frames[0].rgb.numel() * frames[0].rgb.element_size()
    voxel_bytes = grid_bytes - grid.origin.numel() * 4
    bound = bound_ms(2 * voxel_bytes + depth_bytes + color_bytes)  # grid read and written, depth and colour read
    print(
        f"mapping: grid {'x'.join(map(str, spec.dims))} at {spec.voxel_size_m} m, colour {spec.integrate_color}, "
        f"{grid_bytes / 1e6:.1f} MB; {len(frames)} frames "
        f"{frames[0].depth_mm.shape[1]}x{frames[0].depth_mm.shape[0]} (fetch=False); integrate ms: host "
        f"(unsynchronized) median {statistics.median(host_ms[1:]):.3f}, device median "
        f"{statistics.median(device_ms_[1:]):.3f} (first call: host {host_ms[0]:.3f}, device {device_ms_[0]:.3f}); "
        f"bound {bound:.4f} ms ({(2 * voxel_bytes + depth_bytes + color_bytes) / 1e6:.1f} MB: the grid read and "
        f"written, depth and colour read); recenters {mapper.stats.recenters}"
    )

    # The bulk integrator over the same frames and poses, from an empty grid
    # at the mapper's origin: the sequential grid exactly (no recenter here).
    intr = frames[0].intrinsics.matrix
    intr4 = np.asarray([intr[0, 0], intr[1, 1], intr[0, 2], intr[1, 2]], np.float32)
    depths = torch.stack([f.depth_mm for f in frames])
    colors = torch.stack([f.rgb for f in frames])
    cam_t_world = np.stack([np.linalg.inv(p).astype(np.float32) for p in poses])
    scan = make_scan_integrator(spec, donate=True)
    scanned = make_grid(spec, mapper._origin_host, device=dev)
    _sync(dev)
    t = time.perf_counter()
    scan(scanned, depths, colors, cam_t_world, intr4)
    _sync(dev)
    scan_ms = 1e3 * (time.perf_counter() - t) / len(frames)
    if mapper.stats.recenters == 0 and not all(torch.equal(a, b) for a, b in zip(scanned, grid)):
        failures.append("the bulk integrator's grid differs from the sequential integrates'")
    del scanned

    # Maintenance passes, timed on a copy of the grid.
    copy = TsdfGrid(*(t.clone() for t in grid))
    decay_ms = sync_ms(dev, lambda: make_decay(spec, donate=True)(copy, 0.95))
    recenter = make_recenter(spec, donate=True)
    recenter_ms = sync_ms(dev, lambda: recenter(copy, MAP_FORCED_SHIFT), reps=1)
    del copy
    cloud = []
    cloud_ms = sync_ms(dev, lambda: cloud.append(mapper.surface_cloud()))
    meshes = []
    mesh_ms = sync_ms(dev, lambda: meshes.append(mapper.mesh()))
    slices = []
    esdf_ms = sync_ms(dev, lambda: slices.append(mapper.esdf_slice()))
    mesh, (dist, occ, obs, _) = meshes[-1], slices[-1]
    peak = torch.cuda.max_memory_allocated() / 2**20 if dev.type == "cuda" else float("nan")
    print(
        f"mapping: bulk integrate {scan_ms:.3f} ms a frame over {len(frames)}; decay {decay_ms:.3f} ms; recenter by "
        f"{MAP_FORCED_SHIFT} {recenter_ms:.3f} ms; surface cloud {cloud_ms:.3f} ms ({len(cloud[-1][0])} points); mesh "
        f"{mesh_ms:.3f} ms ({len(mesh.vertices)} vertices, {len(mesh.triangles)} triangles, budget hit "
        f"{mesh.vertex_budget_hit}); costmap slice {esdf_ms:.3f} ms ({int(occ.sum())} occupied / {int(obs.sum())} "
        f"observed cells); peak device memory {peak:.1f} MiB"
    )
    if not len(mesh.triangles) > 0 or mesh.vertex_budget_hit:
        failures.append(f"mesh: {len(mesh.triangles)} triangles, budget hit {mesh.vertex_budget_hit}")
    if not occ.any():
        failures.append("costmap: no occupied cell")

    # Synchronizing runtime calls per integrate of a device frame.
    syncs = []
    if dev.type == "cuda":
        profiled = DenseMapper(config, device=dev)
        _sync(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for frame, pose in zip(frames, poses):
                with record_function("phase:integrate"):
                    profiled.integrate(frame, pose)
            _sync(dev)
        spans, inside = _profiled_spans(prof, ("integrate",))
        syncs = [inside(span) for span in spans["integrate"]]
        del profiled
        if len(syncs) != len(frames) or any(syncs):
            failures.append(f"synchronizing runtime calls per integrate {syncs}")
    print(f"mapping: synchronizing runtime calls per integrate of a device frame ({', '.join(_SYNC_CALLS)}): {syncs}")

    # Accuracy: the same frames and poses with the renderer's true depth.
    truth = DenseMapper(config, device=dev)
    tails = []
    for frame, pose, item in zip(frames, poses, items):
        true_mm = _truth_mm(item["truth"])
        truth.integrate(RGBDFrame(rgb=frame.rgb, depth_mm=true_mm, intrinsics=frame.intrinsics,
                                  timestamp=frame.timestamp, camera_name=frame.camera_name), pose)
        est = frame.depth_mm.cpu().numpy().astype(np.float64)
        valid = (est > 0) & (true_mm > 0)
        tails.append((est - true_mm)[valid] / 1000.0)
    tail = np.concatenate(tails)
    beyond = float(np.mean(tail > spec.truncation_m))
    seen, true_seen = grid.weight > 0, truth.grid.weight > 0
    both = seen & true_seen
    near_side = seen & (grid.tsdf >= 0)
    share = float(both.sum() / seen.sum())
    near_share = float((near_side & true_seen).sum() / near_side.sum())
    recall = float(both.sum() / true_seen.sum())
    diff = (grid.tsdf - truth.grid.tsdf).abs()
    med = float(diff[both].median())
    band = both & (truth.grid.tsdf.abs() < spec.truncation_m)
    band_med = float(diff[band].median())
    max_err = MAP_MAX_MEDIAN_TSDF_ERR_VOX * spec.voxel_size_m
    print(
        f"mapping: against the renderer's true depth: {int(seen.sum())} voxels observed ({int(true_seen.sum())} in "
        f"the truth grid); observed there too: {share:.4f} of all, {near_share:.4f} of those on the near side of "
        f"the SGM surface (tsdf >= 0; bar >= {MAP_MIN_TRUTH_SHARE}); the truth grid's observed in the SGM grid "
        f"{recall:.4f} (bar >= {MAP_MIN_TRUTH_SHARE}); the product's valid pixels more than the truncation band "
        f"({spec.truncation_m} m) beyond the truth {beyond:.4f}; median |dtsdf| {med:.5f} m on the voxels both "
        f"observe, {band_med:.5f} m on the {int(band.sum())} of them inside the truth's truncation band (bars <= "
        f"{max_err} m)"
    )
    if not min(near_share, recall) >= MAP_MIN_TRUTH_SHARE or not max(med, band_med) <= max_err:
        failures.append(f"accuracy: near-side share {near_share:.4f}, recall {recall:.4f}, median |dtsdf| "
                        f"{med:.5f} / {band_med:.5f} m")
    if failures:
        raise AssertionError("mapping phase: " + "; ".join(failures))
    return {name: c[ran] for name, c in counts.items()}


def run_runner(dev, klt_levels: int, scan_launches: int, runner_sources, kernels: bool = True) -> dict:
    """The port's ``run_pipeline.run`` as a user calls it, on the card, for
    RUNNER_TICKS ticks of RUNNER_CONFIG (read as ``from_dict`` reads the
    YAML). ``runner_sources`` are the config's synthetic sources with their
    frames rendered ahead (the same frames the runner would render); the
    engine the runner builds is logged (``log_finalized``) to count its
    keyframes. Holds rc 0, the ``Dense map:`` line and the launch identities
    of its ticks and RGB-D frames. Returns the launches."""
    import contextlib
    import io

    from thor_slam_tpu_torch.scripts import run_pipeline, run_slam
    from thor_slam_tpu_torch.utils.config import RunConfig

    cfg = RunConfig.from_dict(RUNNER_CONFIG)
    logs, at_ticks = [], []
    build_engine, build_sources = run_slam.build_engine, run_slam.build_synthetic_sources

    def logged_engine(cfg, device=None):
        engine = build_engine(cfg, device)
        logs.append(log_finalized(engine))
        initialize = engine.initialize

        def counted_initialize(*args, **kwargs):
            # The deployed watchdog's prewarm runs the masked-camera path
            # once here: the ticks' identities hold on the counts after it.
            out = initialize(*args, **kwargs)
            _sync(dev)
            at_ticks.append(kernel_counts())
            return out

        engine.initialize = counted_initialize
        return engine

    out = io.StringIO()
    run_slam.build_engine, run_slam.build_synthetic_sources = logged_engine, lambda cfg: runner_sources
    try:
        _sync(dev)
        reset_kernel_counts()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = run_pipeline.run(cfg, max_frames=RUNNER_TICKS, rgbd_every=RGBD_EVERY, device=dev)
        _sync(dev)
        run_s = time.perf_counter() - t
    finally:
        run_slam.build_engine, run_slam.build_synthetic_sources = build_engine, build_sources
    text = out.getvalue()
    for line in text.splitlines():
        print(f"runner: {line}")
    (log,), (init,) = logs, at_ticks
    counts = kernel_counts()
    ticks = {k: {v: n - init[k][v] for v, n in c.items()} for k, c in counts.items()}
    r = dict(tick_ms=[None] * len(log), keyframes=int(sum(bool(e["diag"]["refreshed"]) for e in log)), counts=ticks)
    failures: list[str] = []
    if rc != 0 or "\nDense map: " not in "\n" + text or len(log) != RUNNER_TICKS:
        failures.append(f"runner: rc {rc}, {len(log)} finalized ticks, a 'Dense map:' line: {'Dense map: ' in text}")
    in_ticks = _check_counts("runner", r, klt_levels, failures, kernels)
    rgbd_frames = RUNNER_TICKS // RGBD_EVERY
    if in_ticks["sgm_scan"] != scan_launches * rgbd_frames or in_ticks["sgm_winner_lr"] < rgbd_frames:
        failures.append(f"runner: SGM launches {ticks} for {rgbd_frames} RGB-D frames")
    print(f"runner: {RUNNER_TICKS} ticks of run_pipeline.run (deployed backend, 4 x 640x400, colour "
          f"{COLOR_RESOLUTION[0]}x{COLOR_RESOLUTION[1]}, mapping at {'x'.join(map(str, cfg.mapping.dims))}) in "
          f"{run_s:.1f} s, keyframes {r['keyframes']}; launch counts after initialize {json.dumps(ticks)}, in "
          f"initialize (the watchdog's prewarm) {json.dumps(init)}")
    if failures:
        raise AssertionError("runner phase: " + "; ".join(failures))
    ran = "kernel" if kernels else "plain"
    return {k: c[ran] for k, c in counts.items()}


def start_euroc_inputs(pool, out_dir, seq_args=EUROC_ARGS):
    """Start rendering phase 10's sequence (the port's
    ``make_euroc_synthetic`` with ``seq_args`` into ``out_dir``) in the
    pool; returns a function that waits for the frames, writes the sequence
    and returns its arguments."""
    from thor_slam_tpu_torch.scripts import make_euroc_synthetic

    args = make_euroc_synthetic.parse_args(["--out", str(out_dir), *seq_args])
    source, traj = make_euroc_synthetic.build_source(args)
    deliver = submit_renders(pool, [source], args.frames)

    def finish():
        deliver()
        t = time.perf_counter()
        imu_samples = make_euroc_synthetic.write_sequence(args, source, traj)
        print(f"euroc: wrote {args.frames} stereo frames of {args.width}x{args.height} + {imu_samples} IMU samples "
              f"in {time.perf_counter() - t:.1f} s")
        return args

    return finish


def _run_euroc_main(dev, seq_dir, argv=(), devices=None, on_call=None) -> dict:
    """The port's ``run_euroc.main`` in this process on ``dev`` over the
    sequence in ``seq_dir`` with the extra ``argv``; ``devices`` replaces
    the engine's ``devices`` (a mesh on one card, which ``--devices`` cannot
    ask for). Each ``process_frames`` is timed with the device synchronized
    after it, ``on_call(engine)`` runs after each (untimed), the counts are
    set to 0 after ``initialize``. Returns rc, the output's text, the
    engine, its finalized ticks, the ms per call and the counts."""
    import contextlib
    import io

    from thor_slam_tpu_torch.scripts import run_euroc

    engines, logs, tick_ms = [], [], []
    build_engine = run_euroc.build_engine

    def timed_engine(args, device):
        if devices is not None:
            args.devices = devices
        engine = build_engine(args, device)
        engines.append(engine)
        logs.append(log_finalized(engine))
        initialize, process = engine.initialize, engine.process_frames

        def counted_initialize(*a, **k):
            out = initialize(*a, **k)
            _sync(dev)
            reset_kernel_counts(TRACKER_KERNELS)
            return out

        def timed_process(fs):
            t = time.perf_counter()
            pose = process(fs)
            _sync(dev)
            tick_ms.append(1e3 * (time.perf_counter() - t))
            if on_call is not None:
                on_call(engine)
            return pose

        engine.initialize, engine.process_frames = counted_initialize, timed_process
        return engine

    out = io.StringIO()
    run_euroc.build_engine = timed_engine
    try:
        with contextlib.redirect_stdout(out):
            rc = run_euroc.main(["--sequence", str(seq_dir), *argv, *(["--cpu"] if dev.type == "cpu" else [])])
        _sync(dev)
    finally:
        run_euroc.build_engine = build_engine
    (engine,), (log,) = engines, logs
    return dict(rc=rc, text=out.getvalue(), engine=engine, log=log, tick_ms=tick_ms,
                counts=kernel_counts(TRACKER_KERNELS))


def run_euroc_phase(dev, seq_args, kernels: bool = True) -> dict:
    """Phase 10: the port's ``run_euroc.main`` in this process, on ``dev`` at
    its defaults (IMU with the accelerometer, BA, loop closure, light ticks),
    over the sequence of ``seq_args``. First both kernels against their
    plain versions on the sequence's own frames; then the run, each
    ``process_frames`` timed (the engine is synchronous: the device is
    synchronized after each), the counts set to 0 after ``initialize``.
    Holds rc 0, every frame tracked from the second on, the launch
    identities and the odometry ATE against the JAX runner's on the same
    sequence. Returns the launches."""
    import re

    from thor_slam_tpu_torch.camera.rig import CameraRig
    from thor_slam_tpu_torch.camera.sources.dataset import EurocCameraSource
    from thor_slam_tpu_torch.slam.interface import TrackingState
    from thor_slam_tpu_torch.engine.tracker import TrackerParams

    src = EurocCameraSource(seq_args.out, max_frames=2)
    with CameraRig([src]) as rig:
        frames = [rig.get_synchronized_frames() for _ in range(2)]
        calibration = rig.calibration
    max_keypoints = TrackerParams.__dataclass_fields__["max_keypoints"].default  # run_euroc's engine's
    check_on_rig_frames(dev, "euroc", frames, calibration, max_keypoints, kernels)

    r = _run_euroc_main(dev, seq_args.out)
    rc, text, engine, log, tick_ms, counts = (r[k] for k in ("rc", "text", "engine", "log", "tick_ms", "counts"))
    for line in text.splitlines():
        print(f"euroc: {line}")
    params = engine._params
    states = [e["state"] for e in log]
    r = dict(tick_ms=tick_ms, keyframes=int(sum(bool(e["diag"]["refreshed"]) for e in log)), counts=counts)
    failures: list[str] = []
    tracked = re.search(r"^Tracked (\d+) frames in [\d.]+s \(([\d.]+) fps\)$", text, re.M)
    ate = re.search(r"^ATE-RMSE: ([\d.]+) cm over \d+ poses \(([\d.]+) m path, (\d+) loop closures", text, re.M)
    world = re.search(r"^world-frame live ATE-RMSE: ([\d.]+) cm", text, re.M)
    kf = re.search(r"^map-trajectory ATE-RMSE: ([\d.]+) cm over (\d+) keyframes$", text, re.M)
    if rc != 0 or not (tracked and ate and kf):
        raise AssertionError(f"euroc phase: rc {rc}, output {text!r}")
    frames_n = seq_args.frames
    if int(tracked.group(1)) != frames_n or len(log) != frames_n or any(s != TrackingState.TRACKING for s in states[1:]):
        failures.append(f"euroc: tracked {tracked.group(1)} of {frames_n} frames, "
                        f"not TRACKING on ticks {[i for i, s in enumerate(states) if s != TrackingState.TRACKING]}")
    launches = _check_counts("euroc", r, params.klt_levels, failures, kernels)
    ate_cm, loops = float(ate.group(1)), int(ate.group(3))
    if not ate_cm <= EUROC_MAX_ATE_FACTOR * EUROC_REF_ATE_CM:
        failures.append(f"euroc: odometry ATE {ate_cm} cm over {EUROC_MAX_ATE_FACTOR} x the JAX runner's "
                        f"{EUROC_REF_ATE_CM} cm")
    light, half = sum(bool(e["light"]) for e in log), sum(bool(e["half"]) for e in log)
    # The engine is synchronous: call i finalized tick i.
    kinds = ["keyframe" if e["diag"]["refreshed"] else "light" if e["light"] else "full" for e in log]
    by_kind = {k: [t for t, kind in zip(tick_ms, kinds) if kind == k] for k in ("keyframe", "light", "full")}
    result = dict(
        frames=frames_n, fps=float(tracked.group(2)), ate_cm=ate_cm, path_m=float(ate.group(2)), loops=loops,
        world_ate_cm=float(world.group(1)) if world else None, map_ate_cm=float(kf.group(1)),
        map_keyframes=int(kf.group(2)), keyframes=r["keyframes"], light_ticks=light, half_res_ticks=half,
        ms_median=statistics.median(tick_ms), ms_p95=float(np.percentile(tick_ms, 95)), ms_max=max(tick_ms),
        ms_median_by_tick_type={k: (len(v), statistics.median(v) if v else None) for k, v in by_kind.items()},
        reference=dict(ate_cm=EUROC_REF_ATE_CM, loops=EUROC_REF_LOOPS, map_ate_cm=EUROC_REF_MAP_ATE_CM),
        max_ate_cm=EUROC_MAX_ATE_FACTOR * EUROC_REF_ATE_CM, launches=launches,
    )
    print("euroc: " + json.dumps(result))
    if failures:
        raise AssertionError("euroc phase: " + "; ".join(failures))
    return launches


class _IdWatch:
    """Called after each synchronous tick: at a keyframe, the ids it minted
    (those at or above the counter before it) must appear once across all
    shards and, in cam mode, no id may sit on two shards (a camera inherits
    only its own landmarks; in slot mode a slot may inherit another
    shard's, as the reference allows)."""

    def __init__(self) -> None:
        self.counter = 0
        self.checks: list[bool] = []

    def __call__(self, engine) -> None:
        st = engine._tracker_state
        if engine.last_diagnostics.get("refreshed"):
            per_shard = [sh.lm_id[sh.lm_valid].cpu().numpy() for sh in st.shards]
            ids = np.concatenate(per_shard)
            fresh = ids[ids >= self.counter]
            ok = len(np.unique(fresh)) == len(fresh)
            if st.axis_mode == "cam":
                sets = [set(x.tolist()) for x in per_shard]
                ok = ok and sum(len(x) for x in sets) == len(set().union(*sets))
            self.checks.append(bool(ok))
        self.counter = int(st.lm_id_counter)

    @property
    def unique(self) -> bool:
        return bool(self.checks) and all(self.checks)


def run_spmd(dev, reuse: dict, seq_args, kernels: bool = True) -> dict:
    """Phase 11: ``TorchSlamEngine`` over a mesh of shards on ``dev``.

    First, on a machine with one card, ``TorchSlamEngine(devices=2)`` must
    raise the reference's ``RuntimeError``. (a) The slice's 40 ticks
    (reused) over SPMD_CAM_SHARDS camera shards, the slice's engine
    arguments; (b) phase 10's sequence, its first SPMD_EUROC_FRAMES frames,
    through ``run_euroc.main`` at its defaults (the IMU's prediction feeds
    the sharded step), on the single device and over SPMD_SLOT_SHARDS slot
    shards. Before each, both kernels against their plain versions at each
    shard's shapes. Each run prints one ``spmd:`` line and is held to: ATE,
    TRACKING, ids unique at every keyframe, the launch identities times the
    shard count; (a) within SPMD_MAX_POSE_DIFF_M of the slice's poses, (b)
    an ATE within SPMD_MAX_ATE_FACTOR of the single device's. Returns the
    launches."""
    import re

    from thor_slam_tpu_torch.camera.rig import CameraRig
    from thor_slam_tpu_torch.camera.sources.dataset import EurocCameraSource
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
    from thor_slam_tpu_torch.slam.interface import SlamConfig, TrackingState
    from thor_slam_tpu_torch.utils.evaluation import ate_rmse

    failures: list[str] = []
    launches: dict[str, int] = {}

    def add(counts: dict) -> None:
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    calibration, traj, frames = reuse["calibration"], reuse["traj"], reuse["all_frames"]
    num_cams, n_kp, levels = len(calibration.source_names), reuse["max_keypoints"], reuse["klt_levels"]
    if dev.type == "cuda" and torch.cuda.device_count() == 1:
        try:
            TorchSlamEngine(devices=2).initialize(calibration, SlamConfig(num_cameras=2 * num_cams))
        except RuntimeError as e:
            if "devices" not in str(e):
                raise
            print(f"spmd: TorchSlamEngine(devices=2) on one card raises RuntimeError: {e}")
        else:
            raise AssertionError("TorchSlamEngine(devices=2) initialized on a machine with one card")

    def ms(tick_ms, log, keyframe):
        sel = [t for t, e in zip(tick_ms, log) if bool(e["diag"]["refreshed"]) == keyframe]
        return statistics.median(sel) if sel else None

    for n in SPMD_CAM_SHARDS:
        label, per = f"spmd cam x{n}", num_cams // n
        for k in range(n):
            check_on_rig_frames(dev, f"{label} shard {k}", frames[:2], calibration, n_kp, kernels,
                                cams=slice(k * per, (k + 1) * per))
        engine = TorchSlamEngine(params=dict(max_keypoints=n_kp), device=dev, devices=[dev] * n, seed=SEED,
                                 **PR6_MODES)
        engine.initialize(calibration, SlamConfig(num_cameras=2 * num_cams, enable_loop_closure=False))
        watch = _IdWatch()
        r = _drive(engine, frames, traj, dev, on_tick=lambda i: watch(engine))
        ate = ate_rmse(r["est"], r["gt"])
        diff = max(float(np.linalg.norm(p.position - q)) for p, q in zip(r["poses"], reuse["positions"])
                   if p is not None and q is not None)
        counts = _check_counts(label, r, levels, failures, kernels, shards=n)
        add(counts)
        result = dict(
            run=label, axis=engine._step.axis_mode, shards=n, ticks=len(frames), ms_median=statistics.median(r["tick_ms"]),
            ms_keyframe_median=ms(r["tick_ms"], r["log"], True), ms_other_median=ms(r["tick_ms"], r["log"], False),
            keyframes=r["keyframes"], launches=counts, ate_cm=100 * ate, single_device_ate_cm=100 * reuse["ate"],
            first_tracking=r["first_tracking"], tracking_share=r["held"], ids_unique_every_keyframe=watch.unique,
            max_pose_diff_vs_single_m=diff,
        )
        print("spmd: " + json.dumps(result))
        if not ate < 0.05 or r["first_tracking"] is None or r["first_tracking"] > 3 or r["held"] < 0.9:
            failures.append(f"{label}: ATE {ate:.4f} m, TRACKING from {r['first_tracking']} on {r['held']:.0%}")
        if not diff < SPMD_MAX_POSE_DIFF_M or not watch.unique:
            failures.append(f"{label}: {diff:.4f} m from the single device, ids unique at keyframes {watch.checks}")
        engine.shutdown()

    n = SPMD_SLOT_SHARDS
    label = f"spmd slot x{n}"
    src = EurocCameraSource(seq_args.out, max_frames=2)
    with CameraRig([src]) as rig:
        euroc_frames = [rig.get_synchronized_frames() for _ in range(2)]
        euroc_cal = rig.calibration
    full_kp = 512  # run_euroc's engine's max_keypoints (the tracker's default)
    for k in range(n):  # each shard detects on the full images and gathers its slots
        check_on_rig_frames(dev, f"{label} shard {k}", euroc_frames, euroc_cal, full_kp // n, kernels)
    argv = ("--frames", str(SPMD_EUROC_FRAMES))
    runs = {}
    for name, devices, watch in (("single", None, None), (label, [dev] * n, _IdWatch())):
        r = _run_euroc_main(dev, seq_args.out, argv, devices=devices, on_call=watch)
        ate = re.search(r"^ATE-RMSE: ([\d.]+) cm", r["text"], re.M)
        if r["rc"] != 0 or not ate:
            raise AssertionError(f"{label} ({name}): rc {r['rc']}, output {r['text']!r}")
        r.update(ate_cm=float(ate.group(1)), keyframes=int(sum(bool(e["diag"]["refreshed"]) for e in r["log"])),
                 watch=watch)
        runs[name] = r
    one, sh = runs["single"], runs[label]
    states = [e["state"] for e in sh["log"]]
    held = float(np.mean([s == TrackingState.TRACKING for s in states[1:]]))  # the first keyframe is tick 0
    diff = max(float(np.linalg.norm(a["pose"].position - b["pose"].position)) for a, b in zip(sh["log"], one["log"])
               if a["pose"] is not None and b["pose"] is not None)
    imu = sum("imu_pred_err_m" in e["diag"] for e in sh["log"])
    add(_check_counts(f"{label} (single device)", one, sh["engine"]._params.klt_levels, failures, kernels))
    counts = _check_counts(label, sh, sh["engine"]._params.klt_levels, failures, kernels, shards=n)
    add(counts)
    result = dict(
        run=label, axis=sh["engine"]._step.axis_mode, shards=n, ticks=len(sh["tick_ms"]),
        ms_median=statistics.median(sh["tick_ms"]), ms_keyframe_median=ms(sh["tick_ms"], sh["log"], True),
        ms_other_median=ms(sh["tick_ms"], sh["log"], False), keyframes=sh["keyframes"], launches=counts,
        ate_cm=sh["ate_cm"], single_device_ate_cm=one["ate_cm"], single_device_ms_median=statistics.median(one["tick_ms"]),
        tracking_share_after_first_keyframe=held, ids_unique_every_keyframe=sh["watch"].unique,
        ticks_with_imu_prediction=imu, max_pose_diff_vs_single_m=diff,
    )
    print("spmd: " + json.dumps(result))
    if held < 0.9 or not sh["ate_cm"] <= SPMD_MAX_ATE_FACTOR * one["ate_cm"] or not sh["watch"].unique or imu == 0:
        failures.append(f"{label}: TRACKING {held:.0%}, ATE {sh['ate_cm']} cm against {one['ate_cm']} cm, "
                        f"ids unique at keyframes {sh['watch'].checks}, {imu} ticks with the IMU's prediction")
    for r in runs.values():
        r["engine"].shutdown()
    if failures:
        raise AssertionError("spmd phase: " + "; ".join(failures))
    return launches


_COPY_CALLS = ("cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy")
#: Phase -> the phases nested in it (a parent's own count excludes them).
_PHASES = {
    "tick": ("track_step",), "track_step": ("hot_frontend", "pnp", "back", "finish_step"), "hot_frontend": (),
    "pnp": (), "back": (), "finish_step": ("keyframe_frontend", "mint_bank"), "keyframe_frontend": (), "mint_bank": (),
}


def tick_launches(dev, width=640, height=400, max_keypoints=512) -> dict:
    """Kernel launches of one tracking tick by phase (``--tick-launches``).

    The slice's engine on the flagship rig: after warm-up, PROFILE_TICKS
    ticks run under torch.profiler with the tracker's phases wrapped in
    named ranges; every runtime launch call is counted into the innermost
    range that holds its start. The profiled engine ticks through the
    eager ``track_step``, whose phases these are. Then a fresh engine runs
    TIMED_TICKS unprofiled ticks (the graphed tick where the tree has one)
    for the tick's time. Works on any tree whose tracker has these
    functions, or the parent's (``_finish_step`` for the back half), so a
    parent can be counted by the same code.
    """
    from torch.profiler import ProfilerActivity, profile, record_function

    from thor_slam_tpu_torch.camera.rig import CameraRig
    from thor_slam_tpu_torch.engine import pnp
    from thor_slam_tpu_torch.engine import tracker as trk
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
    from thor_slam_tpu_torch.slam.interface import SlamConfig
    from thor_slam_tpu_torch.utils.flagship import flagship_rig

    params, _, calibration, sources, _, _ = flagship_rig(4, width, height, max_keypoints)
    total = WARMUP_TICKS + max(PROFILE_TICKS, TIMED_TICKS)
    with CameraRig(sources, rig_extrinsics=calibration.rig_extrinsics) as rig:
        frames = [rig.get_synchronized_frames() for _ in range(total)]
    config = SlamConfig(num_cameras=8, enable_loop_closure=False)

    def engine_after_warmup():
        engine = TorchSlamEngine(params=dict(max_keypoints=params.max_keypoints), device=dev, seed=SEED, **PR6_MODES)
        engine.initialize(calibration, config)
        for fs in frames[:WARMUP_TICKS]:
            engine.process_frames(fs)
        _sync(dev)
        return engine

    def ranged(name, fn):
        def wrapper(*args, **kwargs):
            with record_function(f"phase:{name}"):
                return fn(*args, **kwargs)
        return wrapper

    wrapped = [(trk, "track_step", "track_step"), (trk, "run_hot_frontend", "hot_frontend"),
               (pnp, "ransac_pnp_graphed", "pnp"), (trk, "_back", "back"), (trk, "_complete", "finish_step"),
               (trk, "_finish_step", "finish_step"), (trk, "run_keyframe_frontend", "keyframe_frontend"),
               (trk, "mint_bank", "mint_bank")]
    wrapped = [w for w in wrapped if hasattr(w[0], w[1])]
    if hasattr(trk, "_complete"):  # the split tick: its back half is no longer _finish_step
        wrapped = [w for w in wrapped if w[1] != "_finish_step"]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in wrapped]
    if hasattr(trk, "track_step_graphed"):
        saved.append((trk, "track_step_graphed", trk.track_step_graphed))
    engine = engine_after_warmup()
    for mod, attr, name in wrapped:
        setattr(mod, attr, ranged(name, getattr(mod, attr)))
    if hasattr(trk, "track_step_graphed"):
        trk.track_step_graphed = lambda *args, **kwargs: trk.track_step(*args, **kwargs)
    try:
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=activities) as prof:
            for fs in frames[WARMUP_TICKS : WARMUP_TICKS + PROFILE_TICKS]:
                with record_function("phase:tick"):
                    engine.process_frames(fs)
                _sync(dev)
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    engine.shutdown()

    # A named range comes back twice where it holds kernels: on the host's
    # timeline and, as the span of those kernels, on the device's. Phases and
    # runtime calls are read on the host's; kernels and copies on the device's.
    from torch.autograd import DeviceType

    events = list(prof.events())
    host = [e for e in events if e.device_type == DeviceType.CPU]
    spans = {name: sorted((e.time_range.start, e.time_range.end) for e in host if e.name == f"phase:{name}")
             for name in _PHASES}
    if len(spans["tick"]) != PROFILE_TICKS:
        raise AssertionError(f"{len(spans['tick'])} tick ranges on the host's timeline, not {PROFILE_TICKS}")
    def stamps(names):
        return np.sort(np.asarray([e.time_range.start for e in host if e.name in names], np.float64))

    launch_t, copy_t = stamps(LAUNCH_CALLS), stamps(_COPY_CALLS)
    sync_t = stamps(("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize"))
    kernels = [e for e in events if e.device_type != DeviceType.CPU and not e.name.startswith("phase:")]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)

    def inside(sorted_t, span):
        return int(np.searchsorted(sorted_t, span[1], "right") - np.searchsorted(sorted_t, span[0], "left"))

    ticks = []
    for span in spans["tick"]:
        within = {name: [s for s in spans[name] if span[0] <= s[0] <= span[1]] for name in _PHASES}
        launches = {name: sum(inside(launch_t, s) for s in within[name]) for name in _PHASES}
        copies = sum(inside(copy_t, s) for s in within["tick"])
        own = {name: launches[name] - sum(launches[c] for c in _PHASES[name]) for name in _PHASES}
        own["engine_outside_track_step"] = own.pop("tick")
        own["track_step_rest"] = own.pop("track_step")
        ticks.append(dict(keyframe=bool(within["keyframe_frontend"]), launches=own, total=launches["tick"], copies=copies,
                          syncs_in_track_step=sum(inside(sync_t, s) for s in within["track_step"])))

    def table(rows):
        if not rows:
            return None
        keys = rows[0]["launches"].keys()
        return dict(n=len(rows), total=statistics.median(r["total"] for r in rows),
                    copies=statistics.median(r["copies"] for r in rows),
                    syncs_in_track_step=statistics.median(r["syncs_in_track_step"] for r in rows),
                    **{k: statistics.median(r["launches"][k] for r in rows) for k in keys})

    out = dict(
        non_keyframe=table([t for t in ticks if not t["keyframe"]]), keyframe=table([t for t in ticks if t["keyframe"]]),
        profiled_ticks=len(ticks), launch_calls_per_tick=len(launch_t) / len(ticks),
        device_activities_per_tick=len(kernels) / len(ticks),
        device_busy_ms_per_tick=device_us / 1e3 / len(ticks) if device_us else None,
    )

    # The tick's time, unprofiled, on a fresh engine.
    engine = engine_after_warmup()
    tick_ms, refreshed = [], []
    for fs in frames[WARMUP_TICKS : WARMUP_TICKS + TIMED_TICKS]:
        t = time.perf_counter()
        engine.process_frames(fs)
        _sync(dev)
        tick_ms.append(1e3 * (time.perf_counter() - t))
        refreshed.append(bool(engine.last_diagnostics["refreshed"]))
    engine.shutdown()
    kf = [t for t, r in zip(tick_ms, refreshed) if r]
    hot = [t for t, r in zip(tick_ms, refreshed) if not r]
    out["tick_ms"] = dict(median=statistics.median(tick_ms), keyframe=statistics.median(kf) if kf else None,
                          non_keyframe=statistics.median(hot) if hot else None, n=len(tick_ms), keyframes=len(kf))
    print(f"tick launches by phase (medians over {len(ticks)} profiled ticks): " + json.dumps(out))
    return out


def _as_measure_lines(fn, *args, **kwargs):
    """Call ``fn``; its standard output comes out as ``measure:`` lines (also
    when it raises)."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return fn(*args, **kwargs)
    finally:
        for line in buf.getvalue().splitlines():
            print(f"measure: {line}".rstrip(), flush=True)


def _measure_counts(label: str, counts: dict, want: dict, ran: str, failures: list) -> None:
    """Each kernel of ``want`` launched that often (``ran``: kernel or plain),
    every other kernel not at all, no version of the other kind."""
    other = "plain" if ran == "kernel" else "kernel"
    got = {k: c[ran] for k, c in counts.items()}
    if any(got[k] != want.get(k, 0) for k in got) or any(c[other] for c in counts.values()):
        failures.append(f"{label}: launches {counts}, want {want} ({ran})")


def check_measure_kernels(dev, shapes=MEASURE_SHAPES, kernels: bool = True) -> None:
    """Phase 12's tracker kernels against their plain versions at the shapes
    the phase gives them, before its counts are set to 0. For each
    (WxH, C) of ``shapes``: FAST on (2C, H, W) random images (the stage
    rows'), exactly; for N of MEASURE_KEYPOINTS, exactly, the single-stack
    gather on such a stack (the BRIEF row: S = 37, M = 2C x N), the pair
    gather at every KLT level (S = 19) and on the two eyes of one stack
    (S = 37, strided), M = C x N, with centres past every border; then
    both kernels on the flagship's own frames at N = 256
    (:func:`check_on_rig_frames`). The demos' SGM volume is one of
    SGM_SHAPES."""
    from thor_slam_tpu_torch.ops import fast_cuda, patches_cuda
    from thor_slam_tpu_torch.scripts.profile_stages import flagship_syncs
    from thor_slam_tpu_torch.utils.flagship import flagship_rig

    if not kernels:
        return
    gen = torch.Generator(device="cpu").manual_seed(SEED + 12)

    def pair_exact(what, stacks, cam, centers, size):
        got, clipped = patches_cuda.extract_patches_pair_cuda(*stacks, cam, centers, size)
        want = torch.stack([patches_cuda.extract_patches_flat_plain(s, cam, k, size) for s, k in zip(stacks, centers)])
        _, h, w = stacks[0].shape
        r = size // 2
        clamps = torch.stack([torch.clamp(centers[..., 0], r, w - r - 1),
                              torch.clamp(centers[..., 1], r, h - r - 1)], -1)
        if not torch.equal(got, want) or not torch.equal(clipped, clamps):
            raise AssertionError(f"measure: the pair gather ({what}) differs from its plain version")

    for res, cams, _ in shapes:
        (w, h), c = (int(v) for v in res.split("x")), int(cams)
        params = flagship_rig(num_cams=c, width=w, height=h)[0]
        images = torch.rand((2 * c, h, w), generator=gen).to(dev)
        raw_k, nms_k = fast_cuda.fast_scores_cuda(images, params.fast_threshold)
        raw_p, nms_p = fast_cuda.fast_scores_plain(images, params.fast_threshold)
        err = max(float((raw_k - raw_p).abs().max()), float((nms_k - nms_p).abs().max()))
        if not err <= 1e-6:
            raise AssertionError(f"measure: FAST differs from its plain version by {err} at {2 * c}x{h}x{w}")
        for n in MEASURE_KEYPOINTS:
            stacks, cam, centers = _gather_inputs(gen, (2 * c, h, w), 2 * c * n, dev)
            got = patches_cuda.extract_patches_flat_cuda(stacks[0], cam, centers[0], 37)
            if not torch.equal(got, patches_cuda.extract_patches_flat_plain(stacks[0], cam, centers[0], 37)):
                raise AssertionError(f"measure: the gather (BRIEF row) differs at {2 * c}x{h}x{w}, M={2 * c * n}")
            for level in range(params.klt_levels):
                stacks, cam, centers = _gather_inputs(gen, (c, h >> level, w >> level), c * n, dev)
                pair_exact(f"KLT level {level}, M=2x{c * n}", stacks, cam, centers, 19)
            stacks, cam, centers = _gather_inputs(gen, (c, h, w), c * n, dev)
            both = torch.stack(stacks, 1)
            pair_exact(f"eyes, M=2x{c * n}", (both[:, 0], both[:, 1]), cam, centers, 37)
        _sync(dev)
        print(f"measure: kernels at {res} x {c}: fast9_nms C,H,W={2 * c},{h},{w} max_abs_err={err}; patch_gather "
              f"single stack (S=37) and pair (each KLT level S=19, eyes S=37) exact at N in {MEASURE_KEYPOINTS}")
        calibration, make_sync = flagship_syncs(w, h, c, 2, dev)
        check_on_rig_frames(dev, f"measure {res} x {c}", [make_sync(0), make_sync(1)], calibration, 256)


def run_measure(dev, scan_launches: int, shapes=MEASURE_SHAPES, ablate_res=MEASURE_ABLATE_RES, reps=None,
                ticks=None, render_cams: int = 4, render_res=(640, 400), kernels: bool = True) -> dict:
    """Phase 12 (``measure:`` lines): the port's measurement tools on the
    card; returns the kernel launches of the phase. First every tracker
    kernel against its plain version at the phase's shapes
    (:func:`check_measure_kernels`). ``profile_stages`` at each of
    ``shapes`` with ``--e2e --default`` (its stage rows' launches of the
    gather and FAST held to what their calls imply: FAST one a call of the
    detection, the gather one a call of BRIEF and one a KLT level,
    ``track_step`` the slice's identity); ``ablate_step`` (each variant's
    steps, and FULL's over all its pairings, hold the slice's identity,
    less what its stub removes); the two SGM demos (``scan_launches`` scan
    launches and at least one winner launch a product); the device render
    against the host render. (On the CPU, ``kernels=False`` with small
    ``shapes``, ``reps`` and ``ticks`` rehearses it with the plain
    versions.)"""
    from thor_slam_tpu_torch.engine.tracker import TrackerParams
    from thor_slam_tpu_torch.examples import rgbd_stream, test_stream_resolutions
    from thor_slam_tpu_torch.scripts import ablate_step, profile_stages
    from thor_slam_tpu_torch.utils.flagship import flagship_rig, render_sequence

    check_measure_kernels(dev, shapes, kernels)
    ran = "kernel" if kernels else "plain"
    failures: list[str] = []
    total = {"patch_gather": 0, "fast9_nms": 0, "sgm_scan": 0, "sgm_winner_lr": 0}
    extra = (["--reps", str(reps)] if reps else []) + (["--ticks", str(ticks)] if ticks else [])
    levels = TrackerParams.__dataclass_fields__["klt_levels"].default  # the flagship's
    for res, cams, args in shapes:
        reset_kernel_counts()
        t0 = time.perf_counter()
        out = _as_measure_lines(profile_stages.run, [res, cams, "--e2e", "--default", "--device", str(dev), *args,
                                                     *extra])
        print(f"measure: profile_stages {res} {cams} {' '.join(args)} took {time.perf_counter() - t0:.1f} s")
        for k, c in kernel_counts().items():
            total[k] += c[ran]
        for row in out["stages"]:
            if row["name"] == "SUM of stages":
                continue
            calls, name = row["calls"], row["name"]
            want = ({"fast9_nms": calls} if name.startswith("FAST detect")
                    else {"patch_gather": calls} if name.startswith("BRIEF describe")
                    else {"patch_gather": levels * calls} if name.startswith("KLT track")
                    else {"patch_gather": levels * calls + row["keyframes"], "fast9_nms": row["keyframes"]}
                    if name == "FULL track_step" else {})
            _measure_counts(f"profile_stages {res} {cams}: {name}", row["counts"], want, ran, failures)
            if kernels and want and not row["device_ms"] > 0:
                print(f"measure: {name}: the profiler saw no kernel in its window (device ms not measured)")
        if not all(np.isfinite(v) and v > 0 for v in (out["e2e"]["TOTAL"], *(r["ms_per_tick"]
                                                                                 for r in out["default"].values()))):
            failures.append(f"profile_stages {res} {cams}: e2e {out['e2e']}, default {out['default']}")
    w, h = (int(v) for v in ablate_res.split("x"))
    reset_kernel_counts()
    t0 = time.perf_counter()
    rows = _as_measure_lines(ablate_step.run, w, h, dev, **({"reps": reps} if reps else {}))
    print(f"measure: ablate_step {ablate_res} took {time.perf_counter() - t0:.1f} s")
    for k, c in kernel_counts().items():
        total[k] += c[ran]
    for row in rows:
        steps, kfs = row["steps"], row["all_keyframes"]
        klt = 0 if row["name"] == "no KLT" else levels * steps
        brief = 0 if row["name"] == "no BRIEF" else kfs
        want = {"patch_gather": klt + brief, "fast9_nms": 0 if row["name"] == "no FAST detect" else kfs}
        _measure_counts(f"ablate_step: {row['name']}", row["counts"], want, ran, failures)
        if row["name"] == "FULL" and kfs == 0:
            failures.append("ablate_step: FULL made no keyframe")

    # The two demos that run the RGB-D product (the SGM scan and winner kernels).
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_rgbd_")
    try:
        for name, fn, argv, products in (
            ("rgbd_stream", rgbd_stream.main, ["--frames", "3", "--out", out_dir], 3),
            ("rgbd_stream --color", rgbd_stream.main, ["--frames", "3", "--color", "--out", out_dir], 3),
            ("test_stream_resolutions", test_stream_resolutions.main, [], 2),
        ):
            reset_kernel_counts()
            t0 = time.perf_counter()
            rc = _as_measure_lines(fn, [*argv, "--device", str(dev)])
            counts = kernel_counts()
            print(f"measure: {name} took {time.perf_counter() - t0:.1f} s (rc {rc}), SGM launches "
                  f"{json.dumps({k: counts[k] for k in ('sgm_scan', 'sgm_winner_lr')})}")
            sgm = {k: counts[k] for k in ("sgm_scan", "sgm_winner_lr")}
            if (rc != 0 or sgm["sgm_scan"][ran] != scan_launches * products
                    or sgm["sgm_winner_lr"][ran] < products or any(c["plain" if kernels else "kernel"]
                                                                    for c in sgm.values())):
                failures.append(f"{name}: rc {rc}, SGM launches {sgm} for {products} products, not "
                                f"{scan_launches} scans each")
            for k, c in counts.items():
                total[k] += c[ran]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    # The device render against the host render.
    sources = flagship_rig(num_cams=render_cams, width=render_res[0], height=render_res[1])[3]
    t0 = time.perf_counter()
    host = render_sequence(sources, MEASURE_RENDER_FRAMES)
    host_s = time.perf_counter() - t0
    render_sequence(sources, 1, device=dev)  # warm
    _sync(dev)
    t0 = time.perf_counter()
    on_dev = render_sequence(sources, MEASURE_RENDER_FRAMES, device=dev)
    _sync(dev)
    dev_s = time.perf_counter() - t0
    u8 = lambda x: np.clip(np.asarray(x) * 255.0, 0, 255).astype(np.uint8)  # noqa: E731
    equal = float((u8(on_dev.cpu().numpy()) == u8(host)).mean())
    print(f"measure: render {MEASURE_RENDER_FRAMES} frames x {render_cams} cams x 2 eyes at "
          f"{render_res[0]}x{render_res[1]}: host {1e3 * host_s:.1f} ms, device {1e3 * dev_s:.2f} ms; uint8-equal "
          f"share {equal:.6f} (bar {MIN_RENDER_U8_EQUAL})")
    if not equal >= MIN_RENDER_U8_EQUAL or on_dev.shape != host.shape:
        failures.append(f"device render uint8-equal on {equal:.6f} of the pixels")
    if failures:
        raise AssertionError("measure phase: " + "; ".join(failures))
    return total


def run_bench_slice(dev, res=BENCH_RES, ticks=BENCH_TICKS, kernels: bool = True) -> dict:
    """Phase 13's first half (``bench:`` lines): the slice at the
    benchmark's flagship, 4 stereo cameras at ``res`` with BENCH_KEYPOINTS
    slots a camera. The frames are rendered on ``dev``, converted to uint8
    on the host as the benchmark does and handed to the engine as the
    benchmark's sync factory builds them; both kernels are first held to
    their plain versions on them. The synchronous engine (PR6_MODES) over
    ``ticks`` ticks: TRACKING by tick 3 and on >= 90 % of the ticks after,
    ATE < 5 cm, the gather and FAST launch identities and no plain call.
    Returns the launches. (``kernels=False`` with a small ``res`` and
    ``ticks`` rehearses it on the CPU with the plain versions.)"""
    from thor_slam_tpu_torch import bench
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
    from thor_slam_tpu_torch.slam.interface import SlamConfig
    from thor_slam_tpu_torch.utils.evaluation import ate_rmse
    from thor_slam_tpu_torch.utils.flagship import flagship_rig

    width, height = res
    params, _, calibration, _, _, traj = flagship_rig(4, width, height, BENCH_KEYPOINTS)
    t0 = time.perf_counter()
    host_seq = bench._render_host_frames(4, width, height, ticks, dev)
    make_sync = bench._make_sync_factory(calibration, host_seq, ticks, 30.0, False)
    frames = [make_sync(i) for i in range(ticks)]
    print(f"bench: rendered {ticks} frame sets (4 x 2 x {width}x{height}) on the device in "
          f"{time.perf_counter() - t0:.1f} s")
    check_on_rig_frames(dev, "bench", frames, calibration, BENCH_KEYPOINTS, kernels=kernels)
    config = SlamConfig(num_cameras=8, enable_loop_closure=False)
    overrides = dict(max_keypoints=BENCH_KEYPOINTS)
    warm = TorchSlamEngine(params=overrides, device=dev, seed=SEED, **PR6_MODES)
    warm.initialize(calibration, config)
    for fs in frames[:WARMUP_TICKS]:
        warm.process_frames(fs)
    warm.shutdown()
    engine = TorchSlamEngine(params=overrides, device=dev, seed=SEED, **PR6_MODES)
    engine.initialize(calibration, config)
    r = _drive(engine, frames, traj, dev)
    engine.shutdown()
    ate = ate_rmse(r["est"], r["gt"])
    kf_ms = [t for t, e in zip(r["tick_ms"], r["log"]) if e["diag"]["refreshed"]]
    print(
        f"bench: slice at 4x{width}x{height}, {BENCH_KEYPOINTS} slots: {ticks} ticks, median ms/tick "
        f"{statistics.median(r['tick_ms']):.3f} | keyframe {statistics.median(kf_ms) if kf_ms else float('nan'):.3f} "
        f"(n={r['keyframes']}) | first tick {r['tick_ms'][0]:.1f}; ATE {ate * 100:.3f} cm, TRACKING from tick "
        f"{r['first_tracking']}, held {r['held']:.0%}, inliers at the last tick "
        f"{r['log'][-1]['diag']['num_inliers']}; launches {json.dumps(r['counts'])}"
    )
    failures = []
    if r["first_tracking"] is None or r["first_tracking"] > 3:
        failures.append(f"not TRACKING by tick 3 (first at {r['first_tracking']})")
    elif r["held"] < 0.9:
        failures.append(f"TRACKING held on only {r['held']:.0%} of ticks after tick {r['first_tracking']}")
    if not ate < 0.05:
        failures.append(f"ATE {ate:.4f} m >= 0.05 m")
    launches = _check_counts("bench", r, params.klt_levels, failures, kernels)
    if failures:
        raise AssertionError("bench slice: " + "; ".join(failures))
    return launches


def run_bench_cli(budget_s: float, device_line: str) -> dict:
    """Phase 13's second half: ``python -m thor_slam_tpu_torch.bench`` at
    its defaults in a subprocess with ``BENCH_BUDGET_S=budget_s``. Prints
    its log and its JSON line (``bench: {...}``); asserts exit code 0, every
    key non-null, no phase skipped, ``device`` the card's nvidia-smi line and
    both inlier counts at least BENCH_MIN_INLIERS; returns the launches of
    the port's kernels it logged, which must all be kernels, none of a
    plain version, every kernel launched."""
    env = dict(os.environ, BENCH_BUDGET_S=str(int(budget_s)))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "thor_slam_tpu_torch.bench"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=budget_s + 120)
    took = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        print(line if line.startswith("bench: ") else f"bench: | {line}")
    lines = proc.stdout.strip().splitlines()
    print(f"bench: {lines[-1] if lines else '(no result line)'}")
    print(f"bench: the command took {took:.1f} s (BENCH_BUDGET_S={int(budget_s)}), exit code {proc.returncode}")
    result = json.loads(lines[-1]) if lines else {}
    launched = [json.loads(line.split("kernel launches ", 1)[1])
                for line in proc.stderr.splitlines() if line.startswith("bench: kernel launches ")]
    failures = []
    if proc.returncode != 0:
        failures.append(f"exit code {proc.returncode}")
    if not result or any(v is None for v in result.values()):
        failures.append(f"null keys {[k for k, v in result.items() if v is None] or 'all'}")
    if result.get("phases_skipped") != []:
        failures.append(f"phases skipped {result.get('phases_skipped')}")
    if result.get("device") != device_line:
        failures.append(f"device {result.get('device')!r}, not {device_line!r}")
    for key in ("num_inliers_last", "num_inliers_scan_last"):
        if not (result.get(key) or 0) >= BENCH_MIN_INLIERS:
            failures.append(f"{key} {result.get(key)} < {BENCH_MIN_INLIERS}")
    counts = launched[-1] if launched else {}
    if set(counts) != set(kernel_counts()) or any(c["plain"] or not c["kernel"] for c in counts.values()):
        failures.append(f"kernel launches {counts}")
    if failures:
        raise AssertionError("bench: " + "; ".join(failures))
    return {name: c["kernel"] for name, c in counts.items()}


def run_bench_phase(dev, t_start: float) -> dict:
    """Phase 13: the slice at the benchmark's flagship, then the benchmark
    with the time the run has left; returns the launches of both."""
    launches = run_bench_slice(dev)
    torch.cuda.empty_cache()
    budget = CHIP_LIMIT_S - (time.perf_counter() - t_start) - BENCH_MARGIN_S
    for name, n in run_bench_cli(budget, nvidia_smi_line()).items():
        launches[name] = launches.get(name, 0) + n
    return launches


# Patrol phase (--patrol): the benchmark's patrol cell, one run a seed
# through benchmark.run.run_cell, with a recorder on the loop backend and
# the engine. Every closure's graph is solved again on the card by the
# plain reference in float64, and in bfloat16 as the control, which must
# lie outside the tolerances the program's float32 solve keeps to.
PATROL_CELL = "oak4-640x400-patrol.orbit-loop"
PATROL_SECONDS = 51.0
PATROL_SEEDS = (3210000101, 3210000102, 3210000103)


@contextlib.contextmanager
def closures_recorded():
    """Every loop closure a ``LoopBackend`` applies inside the block, in the
    yielded list: ``graph`` (the solved ``PoseGraph``'s fields, host arrays),
    ``poses`` (its padded solve), ``t_corr``, ``kk``, ``ci``, ``qi``,
    ``query_ts`` (the query keyframe's time) and ``at`` (host clock). Wraps
    the loop backend module's ``posegraph.optimize`` and ``LoopBackend.poll``."""
    from thor_slam_tpu_torch.engine.backends import loop_closure

    out, last = [], []
    optimize, poll = loop_closure.posegraph.optimize, loop_closure.LoopBackend.poll

    def recorded_optimize(graph, *args, **kwargs):
        poses, rms = optimize(graph, *args, **kwargs)
        last[:] = [({k: v.cpu().numpy() for k, v in graph._asdict().items()}, poses.cpu().numpy())]
        return poses, rms

    def recorded_poll(self, *args, **kwargs):
        res = poll(self, *args, **kwargs)
        if res is not None:
            t_corr, _, kk, info = res
            graph, poses = last[0]
            out.append(dict(graph=graph, poses=poses, t_corr=t_corr, kk=kk, ci=info["ci"], qi=info["qi"],
                            query_ts=self.db[info["qi"]]["ts"], at=time.perf_counter()))
        return res

    loop_closure.posegraph.optimize, loop_closure.LoopBackend.poll = recorded_optimize, recorded_poll
    try:
        yield out
    finally:
        loop_closure.posegraph.optimize, loop_closure.LoopBackend.poll = optimize, poll


def check_closure(c: dict, dev) -> dict:
    """One recorded closure against the plain reference: the program's
    solve and the bfloat16 control's, each against the float64 solve."""
    from benchmark.reference import posegraph as plain

    graph = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in c["graph"].items()}
    t0 = time.perf_counter()
    ref64, _ = plain.optimize(**graph)
    ref_s = time.perf_counter() - t0
    ctrl, _ = plain.optimize(**graph, dtype=torch.bfloat16)
    trans, rot = plain.pose_differences(c["poses"], ref64)
    c_trans, c_rot = plain.pose_differences(ctrl, ref64)
    return dict(nodes=c["kk"], ci=c["ci"], qi=c["qi"], query_ts=round(c["query_ts"], 4), program_m=trans,
                program_rot=rot, control_m=c_trans, control_rot=c_rot, ref_s=round(ref_s, 3),
                agrees=trans < plain.TRANS_TOL_M and rot < plain.ROT_TOL,
                control_fails=c_trans > plain.TRANS_TOL_M or c_rot > plain.ROT_TOL)


def record_patrol(dev, seed: int, seconds: float = PATROL_SECONDS) -> dict:
    """One untraced run of the patrol cell with its bfloat16 control: the
    result, every closure checked against the plain reference and against
    the truth, and the window's ATE of the odometry and of the map-lifted
    trajectory (``map_t_odom @ pose``)."""
    import benchmark.core.driver as driver_mod
    import benchmark.core.system as system_mod
    from benchmark.core import spec
    from benchmark.run import run_cell
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine

    bench = spec.load_benchmark()
    cell = spec.cell(PATROL_CELL, bench)
    cfg, mix = spec.config(cell["config"], bench), spec.traffic(cell["traffic"])
    fps = float(mix["fps"])
    held: dict = {"ticks": []}
    process, build, driver_cls = TorchSlamEngine.process_frames, system_mod.build, driver_mod.Driver

    def logged_process(self, frame_set):
        pose = process(self, frame_set)
        if pose is not None and held["driver"].in_window:
            held["ticks"].append((int(round(pose.timestamp * fps)), pose.to_4x4_matrix(), self.map_t_odom))
        return pose

    def logged_build(*args, **kwargs):
        held["system"] = build(*args, **kwargs)
        return held["system"]

    class Driver(driver_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            held["driver"] = self

    TorchSlamEngine.process_frames, system_mod.build, driver_mod.Driver = logged_process, logged_build, Driver
    try:
        with closures_recorded() as recorded:
            result = run_cell(cell, cfg, mix, spec.limits(PATROL_CELL), bench, seed, seconds, False, dev,
                              log=lambda m: print(f"patrol: {m}"), control=torch.bfloat16)
    finally:
        TorchSlamEngine.process_frames, system_mod.build, driver_mod.Driver = process, build, driver_cls
    rig = held["system"].rig

    closures = []
    for c in recorded:
        k = int(round(c["query_ts"] * fps))
        truth = rig.gt_poses([k]).numpy()[0]
        q_map = c["graph"]["poses"][c["qi"]].astype(np.float64)
        odo = next((m for kp, m, _ in held["ticks"] if kp == k), None)
        closures.append(dict(
            check_closure(c, dev), corr_m=float(np.linalg.norm(c["t_corr"][:3, 3])),
            truth_corr_m=float(np.linalg.norm(truth[:3, 3] - q_map[:3, 3])),
            odo_err_m=None if odo is None else float(np.linalg.norm(odo[:3, 3] - truth[:3, 3])),
            map_err_after_m=float(np.linalg.norm((c["t_corr"] @ q_map)[:3, 3] - truth[:3, 3])),
        ))

    gt = rig.gt_poses([kp for kp, _, _ in held["ticks"]]).numpy()
    odo = np.stack([m for _, m, _ in held["ticks"]])
    world = np.stack([mto @ m for _, m, mto in held["ticks"]])
    ate = {name: float(np.sqrt(np.mean(np.sum((x[:, :3, 3] - gt[:, :3, 3]) ** 2, -1))) * 100)
           for name, x in (("odometry", odo), ("world", world))}
    return dict(
        seed=seed, correct=result["correct"], control_correct=result["control_correct"], failed=result["failed"],
        attempted=result["attempted"], metrics={k: v["value"] for k, v in result["metrics"].items()},
        readings=result["readings"], control_readings=result["control_readings"],
        memory_peak_bytes=result["device"]["memory_peak_bytes"], render_s=rig.render_s, host_bytes=rig.host_bytes,
        ate_cm=ate, closures=closures,
    )


def run_patrol(dev, seeds) -> bool:
    """``--patrol``: :func:`record_patrol` for each seed, a JSON line each;
    True when every run is correct, its control not, every solve agrees
    with the plain reference and every control solve lies outside."""
    ok = True
    for seed in seeds:
        out = record_patrol(dev, seed)
        print(f"patrol: {json.dumps(out)}", flush=True)
        ok &= out["correct"] and not out["control_correct"] and bool(out["closures"])
        ok &= all(c["agrees"] and c["control_fails"] for c in out["closures"])
        torch.cuda.empty_cache()
    return ok


def main() -> int:
    t_start = time.perf_counter()
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

    if "--tick-launches" in sys.argv[1:]:
        # The launch table alone (see the module docstring): no result line.
        print(json.dumps({"tick_launches": tick_launches(dev)}))
        return 0
    if "--bench-only" in sys.argv[1:]:
        # Phase 13 alone (see the module docstring): no result line.
        print(f"bench: phase launches {json.dumps(run_bench_phase(dev, t_start))}")
        return 0
    if "--patrol" in sys.argv[1:]:
        # The patrol recorder alone (see the module docstring): no result line.
        seeds = [int(a) for a in sys.argv[sys.argv.index("--patrol") + 1 :] if a.isdigit()] or PATROL_SEEDS
        return 0 if run_patrol(dev, seeds) else 1
    if "--engine-only" in sys.argv[1:]:
        # The full-engine phase alone (see the module docstring): no result line.
        check_full_engine(run_full_engine(dev, render_full_inputs(), **PR6_MODES))
        return 0
    t_kernels = time.perf_counter()
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
    print(f"kernel phase took {time.perf_counter() - t_kernels:.1f} s")
    torch.cuda.empty_cache()
    workers = min(RENDER_WORKERS, max(1, (os.cpu_count() or 2) - 2))
    pool = ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))
    euroc_dir = tempfile.mkdtemp(prefix="chip_smoke_euroc_")
    try:
        t0 = time.perf_counter()
        launches, periods, reuse = run_slice(dev, scan["launches_per_call"], pool)
        print(f"slice phase took {time.perf_counter() - t0:.1f} s")
        per_period = {name: n / periods for name, n in launches.items()}  # a period: RGBD_EVERY ticks
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        inputs = render_full_inputs(pool=pool)
        full_run = run_full_engine(dev, inputs, **PR6_MODES)
        full = check_full_engine(full_run)
        print(f"engine: phase took {time.perf_counter() - t0:.1f} s, launches {json.dumps(full)}")
        phases = {"engine": full}
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        deployed_run = run_full_engine(dev, inputs, label="deployed", stage_solves=False, **DEPLOYED_MODES)
        phases["deployed"] = check_full_engine(deployed_run, label="deployed", want_light=True)
        # The profiled calls are counted, not timed: the later phases' frames
        # render in the pool meanwhile.
        from thor_slam_tpu_torch.scripts.run_slam import build_synthetic_sources
        from thor_slam_tpu_torch.utils.config import RunConfig

        mono_inputs = start_mono_inputs(pool=pool)
        runner_sources = build_synthetic_sources(RunConfig.from_dict(RUNNER_CONFIG))
        deliver_runner = submit_renders(pool, runner_sources[0], RUNNER_TICKS)
        euroc_inputs = start_euroc_inputs(pool, euroc_dir)
        t1 = time.perf_counter()
        syncs = sync_calls_by_tick_type(dev, inputs)
        print(f"deployed: the profiled calls took {time.perf_counter() - t1:.1f} s")
        print(f"deployed: phase took {time.perf_counter() - t0:.1f} s, launches {json.dumps(phases['deployed'])}")
        t0 = time.perf_counter()
        mono_inputs = mono_inputs()
        deliver_runner()
        euroc_args = euroc_inputs()
        print(f"renders of the mono, runner and euroc phases: waited {time.perf_counter() - t0:.1f} s after the "
              "profiled calls (the sequence's files written)")
        t0 = time.perf_counter()
        phases["deep"] = run_deep(dev, inputs, reuse)
        print(f"deep: phase took {time.perf_counter() - t0:.1f} s, launches {json.dumps(phases['deep'])}")
        del inputs
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        phases["mono"] = run_mono_phases(dev, reuse, mono_inputs)
        print(f"mono phases took {time.perf_counter() - t0:.1f} s ({workers} render workers), "
              f"launches {json.dumps(phases['mono'])}")
        del mono_inputs
    except BaseException:
        shutil.rmtree(euroc_dir, ignore_errors=True)
        raise
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phases["mapping"] = run_mapping(dev, reuse, scan["launches_per_call"])
    print(f"mapping: phase took {time.perf_counter() - t0:.1f} s, launches {json.dumps(phases['mapping'])}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phases["runner"] = run_runner(dev, reuse["klt_levels"], scan["launches_per_call"], runner_sources)
    print(f"runner: phase took {time.perf_counter() - t0:.1f} s, launches {json.dumps(phases['runner'])}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        phases["euroc"] = run_euroc_phase(dev, euroc_args)
        print(f"euroc: phase took {time.perf_counter() - t0:.1f} s, launches {json.dumps(phases['euroc'])}")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        phases["spmd"] = run_spmd(dev, reuse, euroc_args)
        print(f"spmd: phase took {time.perf_counter() - t0:.1f} s, launches {json.dumps(phases['spmd'])}")
    finally:
        shutil.rmtree(euroc_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phases["defer_sync"] = run_defer_sync(dev, reuse)
    phases["half"] = run_half(dev, reuse)
    print(f"defer_sync and half phases took {time.perf_counter() - t0:.1f} s")
    print("modes: " + json.dumps(dict(
        synchronous_ms_per_call=statistics.median(full_run["tick_ms"]),
        synchronous_ms_per_tick_over_run=1e3 * full_run["run_s"] / len(full_run["tick_ms"]),
        deployed_ms_per_call=statistics.median(deployed_run["tick_ms"]),
        deployed_ms_per_call_p95=float(np.percentile(deployed_run["tick_ms"], 95)),
        deployed_ms_per_tick_over_run=1e3 * deployed_run["run_s"] / len(deployed_run["tick_ms"]),
        deployed_light_share=sum(deployed_run["light"]) / len(deployed_run["light"]),
        deployed_half_share=sum(deployed_run["half"]) / len(deployed_run["half"]),
        deployed_paced_calls=deployed_run["paced_calls"],
        sync_calls_by_tick_type=syncs,
    )))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phases["measure"] = run_measure(dev, scan["launches_per_call"])
    print(f"measure: phase took {time.perf_counter() - t0:.1f} s, launches {json.dumps(phases['measure'])}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phases["bench"] = run_bench_phase(dev, t_start)
    print(f"bench: phase took {time.perf_counter() - t0:.1f} s, launches {json.dumps(phases['bench'])}")
    for counts in phases.values():
        for name, n in counts.items():
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
    print(f"run: {time.perf_counter() - t_start:.1f} s on {nvidia_smi_line()}")
    print(json.dumps(record))
    device = {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
