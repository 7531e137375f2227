"""SLAM runner: config -> sources -> rig -> TorchSlamEngine -> pose stream.

Port of the JAX package's ``scripts/run_slam.py``: loads the YAML config,
builds the synthetic camera sources, and runs the tracking hot loop with
the same status-line UX. The engine runs on the card unless ``--device``
says otherwise (``--device cpu`` runs the plain PyTorch versions).

Not ported yet (ROADMAP Queue 1 #16): hardware camera sources (a config
that lists cameras without ``synthetic.enabled``) and ``--ros``; both
report so and return 2, as the reference does without depthai or rclpy.

Usage:
    python -m thor_slam_tpu_torch.scripts.run_slam --config config/slam_config.yaml --synthetic
    python -m thor_slam_tpu_torch.scripts.run_slam --synthetic --frames 120
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import time

logger = logging.getLogger("run_slam")

_shutdown = False

HARDWARE_NOT_PORTED = (
    "hardware camera sources (luxonis.py, camera/utils.py) are not ported yet "
    "(ROADMAP Queue 1 #16); run with --synthetic or synthetic.enabled"
)
ROS_NOT_PORTED = "--ros: the ROS 2 adapters (slam/adapters/) are not ported yet (ROADMAP Queue 1 #16)"


def _handle_signal(signum, frame):
    global _shutdown
    _shutdown = True


def build_synthetic_sources(cfg):
    """Hardware-free rig from the config's synthetic section."""
    from thor_slam_tpu_torch.camera.sources.synthetic import (
        OrbitTrajectory,
        SyntheticRigSpec,
        SyntheticWorld,
        make_synthetic_rig,
    )

    syn = cfg.synthetic
    spec = SyntheticRigSpec(
        num_sources=syn.num_cameras,
        stereo=True,
        width=syn.resolution[0],
        height=syn.resolution[1],
        baseline_m=syn.baseline_m,
        fps=cfg.fps,
        imu_rate_hz=cfg.imu_report_rate,
        color_camera=syn.color_camera,
        color_resolution=syn.color_resolution,
    )
    world = SyntheticWorld(half_extents=syn.room_half_extents)
    traj = OrbitTrajectory(radius=syn.trajectory_radius)
    sources, rig_ext, _, _ = make_synthetic_rig(spec, world=world, trajectory=traj)
    return sources, rig_ext


def build_engine(cfg, device=None):
    """``TorchSlamEngine`` from the config's ``backend`` section, with exactly
    the arguments the reference's runners give their engine (which leaves
    ``backend.enable_loop_closure`` out: the engine's default holds)."""
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine

    return TorchSlamEngine(
        params=dict(max_keypoints=cfg.backend.max_keypoints, **cfg.backend.tracker),
        enable_ba=cfg.backend.enable_ba,
        use_imu=cfg.backend.use_imu,
        use_accel=cfg.backend.use_accel,
        prewarm_degraded=cfg.watchdog_timeout_s is not None,
        pipelined=cfg.backend.pipelined,
        pipeline_depth=cfg.backend.pipeline_depth,
        devices=cfg.backend.devices,
        light_ticks=cfg.backend.light_ticks,
        light_half_res=cfg.backend.light_half_res,
        adaptive_half_res=cfg.backend.adaptive_half_res,
        imu_noise=cfg.backend.imu_noise,
        device=device,
    )


def build_rig(cfg, sources, rig_ext):
    from thor_slam_tpu_torch.camera.rig import CameraRig

    return CameraRig(
        sources,
        queue_size=cfg.rig_queue_size,
        rig_extrinsics=rig_ext,
        imu_source=sources[0].name if sources[0].has_sensor_data else None,
        watchdog_timeout_s=cfg.watchdog_timeout_s,
    )


def _display_frames(sync) -> None:
    """Per-camera OpenCV windows; no-op on headless hosts."""
    try:
        import cv2
    except ImportError:
        return
    try:
        for name, fs in sync.frame_sets.items():
            cv2.imshow(name, fs.frames[0].image)
        cv2.waitKey(1)
    except cv2.error:  # headless build / no display
        pass


def run(
    cfg,
    max_frames: int | None = None,
    save_map_path: str | None = None,
    use_ros: bool = False,
    device=None,
) -> int:
    """Run the tracking loop; ``device=None`` is the card (raises without
    one), ``"cpu"`` the plain versions. Returns the exit code."""
    from thor_slam_tpu_torch.pipeline.bus import MessageBus
    from thor_slam_tpu_torch.slam.interface import SlamConfig
    from thor_slam_tpu_torch.utils.profiling import PipelineStats

    if use_ros:
        logger.error("%s", ROS_NOT_PORTED)
        return 2
    if not (cfg.synthetic.enabled or not cfg.cameras):
        logger.error("%s", HARDWARE_NOT_PORTED)
        return 2
    sources, rig_ext = build_synthetic_sources(cfg)

    bus = MessageBus()
    pose_topic = bus.topic("/slam/pose", queue_size=30)
    stats = PipelineStats()
    engine = build_engine(cfg, device)
    rig = build_rig(cfg, sources, rig_ext)

    frame_count = 0
    try:
        rig.start()
        logger.info("Initializing engine...")
        engine.initialize(rig.calibration, SlamConfig(num_cameras=cfg.num_cameras, expected_fps=cfg.fps))

        last_status = time.monotonic()
        while not _shutdown and (max_frames is None or frame_count < max_frames):
            with stats.stage("sync").time():
                sync = rig.get_synchronized_frames()
            if sync is None:
                time.sleep(0.001)
                continue
            with stats.stage("track").time():
                pose = engine.process_frames(sync)
            frame_count += 1
            stats.fps.tick()
            stats.max_time_delta_ms = sync.max_time_delta * 1000.0
            stats.tracking_state = engine.get_tracking_state().name
            stats.num_inliers = engine.last_diagnostics.get("num_inliers", 0)
            if pose is not None:
                pose_topic.publish(pose)

            if cfg.display:
                _display_frames(sync)

            now = time.monotonic()
            if now - last_status >= 2.0:  # the reference's cadence
                print(stats.status_line(frame_count), flush=True)
                last_status = now
    finally:
        rig.stop()
        final = engine.flush()  # finalize the in-flight pipelined tick
        if final is not None:
            pose_topic.publish(final)
        if save_map_path:
            ok = engine.save_map(save_map_path)
            logger.info("Map save to %s: %s", save_map_path, "ok" if ok else "FAILED")
        m = engine.get_map()
        print(
            f"Done: {frame_count} frames | map: {len(m.points)} points, "
            f"{len(m.keyframe_poses)} keyframes",
            flush=True,
        )
        engine.shutdown()
    return 0


def load_run_config(path):
    """(config, None), or (None, exit code) after logging a config error."""
    from thor_slam_tpu_torch.utils.config import ConfigError, RunConfig, load_config

    try:
        return (load_config(path) if path else RunConfig()), None
    except (ConfigError, FileNotFoundError) as e:
        logger.error("%s", e)
        return None, 2


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default=None, help="YAML config path (needs pyyaml)")
    parser.add_argument("--synthetic", action="store_true", help="Force the synthetic rig")
    parser.add_argument("--frames", type=int, default=None, help="Stop after N frames")
    parser.add_argument("--save-map", default=None, help="Save the map on exit (npz)")
    parser.add_argument("--ros", action="store_true", help="Publish to ROS 2 (not ported yet)")
    parser.add_argument("--device", default=None, help="Compute device (default: the current CUDA device)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")

    # Fail fast on operator mistakes before the engine comes up.
    if args.ros:
        logger.error("%s", ROS_NOT_PORTED)
        return 2
    cfg, rc = load_run_config(args.config)
    if cfg is None:
        return rc
    if args.synthetic:
        cfg.synthetic.enabled = True

    signal.signal(signal.SIGINT, _handle_signal)
    signal.signal(signal.SIGTERM, _handle_signal)
    return run(cfg, max_frames=args.frames, save_map_path=args.save_map, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
