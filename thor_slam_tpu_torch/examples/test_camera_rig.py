"""Rig synchronization diagnostics.

Port of the JAX package's ``examples/test_camera_rig.py``, on the port's
``CameraRig`` and sources.

The reference uses this as its de-facto hardware-in-the-loop verification
tool: per-camera FPS windows, sync-delta statistics, live display
(reference test_camera_rig.py:142-152, 299-382). This version runs
hardware-free on the synthetic rig by default (with injected clock offsets
and jitter, so the statistics have known ground truth), or replays a EuRoC
directory; the printed statistics match the reference tool's.

Usage: python -m thor_slam_tpu_torch.examples.test_camera_rig [--cameras 4] [--frames 60]
       python -m thor_slam_tpu_torch.examples.test_camera_rig --display        # cv2 windows
       python -m thor_slam_tpu_torch.examples.test_camera_rig --interactive    # pick a resolution
       python -m thor_slam_tpu_torch.examples.test_camera_rig --euroc /data/MH_01_easy
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict, deque

import numpy as np


def _window_fps(times: deque[float]) -> float:
    if len(times) < 2:
        return 0.0
    span = times[-1] - times[0]
    return (len(times) - 1) / span if span > 0 else 0.0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--cameras", type=int, default=4)
    parser.add_argument("--frames", type=int, default=60)
    parser.add_argument("--jitter-ms", type=float, default=3.0)
    parser.add_argument("--euroc", default=None, help="EuRoC sequence dir")
    parser.add_argument("--display", action="store_true", help="cv2 windows per camera")
    parser.add_argument(
        "--interactive", action="store_true",
        help="Prompt for a stream resolution (the reference's negotiation UX)",
    )
    args = parser.parse_args(argv)

    from thor_slam_tpu_torch.camera.rig import CameraRig

    # Resolution negotiation: the reference probes each camera's supported
    # configs and prompts for a common choice (reference
    # examples/test_camera_rig.py:182-245). The synthetic rig supports any
    # size; offer the OAK-typical menu.
    width, height = 320, 200
    if args.interactive:
        from thor_slam_tpu_torch.camera.utils import prompt_for_resolution

        choice = prompt_for_resolution(
            [(640, 400), (1280, 720), (1280, 800), (320, 200)],
            prompt="Common resolutions supported by every source",
        )
        if choice is None:
            print("aborted")
            return 1
        width, height = choice

    injected_offsets: dict[str, float] = {}
    if args.euroc:
        from thor_slam_tpu_torch.camera.sources.dataset import EurocCameraSource

        sources = [EurocCameraSource(args.euroc)]
        rig_ext = None
    else:
        from thor_slam_tpu_torch.camera.sources.synthetic import SyntheticRigSpec, make_synthetic_rig

        offsets = tuple(0.002 * i for i in range(args.cameras))
        spec = SyntheticRigSpec(num_sources=args.cameras, width=width, height=height)
        sources, rig_ext, _, _ = make_synthetic_rig(
            spec, clock_offsets=offsets, jitter_std=args.jitter_ms / 1000.0
        )
        injected_offsets = {s.name: o for s, o in zip(sources, offsets)}

    cv2 = None
    if args.display:
        try:
            import cv2  # type: ignore[no-redef]
        except ImportError:
            print("cv2 not available; continuing without display")

    # Statistics: per-camera FPS windows (last 60 arrivals), per-source
    # signed offset from the sync reference, global sync deltas.
    arrival: dict[str, deque[float]] = defaultdict(lambda: deque(maxlen=60))
    source_offset_ms: dict[str, list[float]] = defaultdict(list)
    deltas: list[float] = []
    t0 = time.monotonic()

    with CameraRig(sources, rig_extrinsics=rig_ext) as rig:
        for i in range(args.frames):
            sync = rig.get_synchronized_frames()
            if sync is None:
                time.sleep(0.001)
                continue
            now = time.monotonic()
            deltas.append(sync.max_time_delta * 1000.0)
            for name, fs in sync.frame_sets.items():
                arrival[name].append(now)
                source_offset_ms[name].append((fs.timestamp - sync.timestamp) * 1000.0)
                if cv2 is not None:
                    for f in fs.frames:
                        cv2.imshow(f.camera_name, f.image)
            if cv2 is not None:
                cv2.waitKey(1)
            if i % 20 == 0:
                fps = {n[-6:]: f"{_window_fps(a):.1f}" for n, a in arrival.items()}
                print(
                    f"frame {i:3d}: max_dt={deltas[-1]:6.2f} ms  fps={fps}  "
                    f"queues={rig.get_queue_depths()}"
                )
        final_depths = rig.get_queue_depths()
    if cv2 is not None:
        cv2.destroyAllWindows()

    elapsed = time.monotonic() - t0
    d = np.asarray(deltas)
    print("\n" + "=" * 72)
    print("Final statistics")
    print("=" * 72)
    print(f"Synchronized sets: {len(d)} in {elapsed:.2f} s ({len(d) / elapsed:.1f} sets/s)")
    print(
        f"Sync delta: mean={d.mean():.2f} ms  p50={np.percentile(d, 50):.2f}  "
        f"p95={np.percentile(d, 95):.2f}  max={d.max():.2f}  min={d.min():.2f}"
    )
    print(f"Final queue depths: {final_depths}")
    print("\nPer-source offset from the sync reference (the slowest camera):")
    for name in sorted(source_offset_ms):
        off = np.asarray(source_offset_ms[name])
        line = (
            f"  {name:24s} mean={off.mean():+7.2f} ms  sigma={off.std():5.2f}  "
            f"fps={_window_fps(arrival[name]):5.1f}"
        )
        if name in injected_offsets:
            # Synthetic mode: the measured skew should recover the offset
            # injected into each source's clock (relative to the slowest).
            line += f"   (injected clock offset {injected_offsets[name] * 1000:+.1f} ms)"
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
