"""SLAM runner: config -> sources -> rig -> TorchSlamEngine -> pose stream.

Port of the JAX package's ``scripts/run_slam.py``: loads the YAML config,
builds camera sources (synthetic by default; Luxonis when depthai is
installed and the config lists real IPs, with URDF rig extrinsics and the
IMU's DRB->RDF convention composed into the rig frame), and runs the
tracking hot loop with the same status-line UX. ``--ros`` publishes
odometry, TF and the sparse clouds through ``RosBridge``. Without depthai
or rclpy those two branches log why and return 2, as the reference's do.
The engine runs on the card unless ``--device`` says otherwise
(``--device cpu`` runs the plain PyTorch versions).

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


def build_hardware_sources(cfg):
    """Luxonis OAK sources from the config's camera list (requires depthai)."""
    from thor_slam_tpu_torch import geometry
    from thor_slam_tpu_torch.camera.sources.luxonis import (
        LuxonisCameraConfig,
        LuxonisCameraSource,
        LuxonisRGBDCameraConfig,
    )
    from thor_slam_tpu_torch.camera.types import Extrinsics, IMUExtrinsics, IPv4
    from thor_slam_tpu_torch.camera.utils import load_rig_extrinsics_from_urdf

    rgbd_ips = set(cfg.rgbd_camera_ips())
    sources = []
    for i, cam in enumerate(cfg.cameras):
        # RGB-D cameras get the CAM_A color leg at its own (sensor, output)
        # resolutions, independent of the SLAM stream.
        rgbd = None
        if cam.ip in rgbd_ips and cam.stereo:
            rgbd = LuxonisRGBDCameraConfig(
                rgb_sensor_resolution=cam.rgb_sensor_resolution,
                rgb_output_resolution=cam.rgb_output_resolution,
            )
        lux_cfg = LuxonisCameraConfig(
            ip=IPv4(cam.ip),
            fps=cfg.fps,
            stereo=cam.stereo,
            sensor_type=cam.sensor_type,
            resolution=cam.resolution,
            output_resolution=cam.output_resolution,
            queue_size=cfg.queue_size,
            read_imu=(i == 0),  # IMU from the first camera
            imu_report_rate=cfg.imu_report_rate,
            rgbd=rgbd,
        )
        sources.append(LuxonisCameraSource(lux_cfg))

    rig_ext = {}
    imu_ext = None
    if cfg.urdf_path:
        camera_map = {c.ip: f"link_Camera_{i + 1}" for i, c in enumerate(cfg.cameras)}
        rig_ext = load_rig_extrinsics_from_urdf(cfg.urdf_path, camera_map)

    # IMU extrinsics: sensor frame is DRB on OAK-D Pro -> convert to RDF and
    # compose into the rig frame.
    imu_src = sources[0]
    sensor_ext = imu_src.get_sensor_extrinsics()
    if sensor_ext is not None:
        imu_rdf = geometry.DRB_TO_RDF_MATRIX @ sensor_ext.to_4x4_matrix()
        base = rig_ext.get(cfg.cameras[0].ip)
        world_imu = (base.to_4x4_matrix() @ imu_rdf) if base else imu_rdf
        imu_ext = IMUExtrinsics(
            source_name=cfg.cameras[0].ip, extrinsics=Extrinsics.from_4x4_matrix(world_imu)
        )
    return sources, rig_ext, imu_ext


def build_sources(cfg):
    """(sources, rig extrinsics, IMU extrinsics) of the config: the synthetic
    rig (no IMU extrinsics) or the hardware cameras. Raises ImportError
    without depthai."""
    if cfg.synthetic.enabled or not cfg.cameras:
        return (*build_synthetic_sources(cfg), None)
    return build_hardware_sources(cfg)


def ros_missing(use_ros: bool, log: logging.Logger = logger) -> bool:
    """Whether ``--ros`` was asked for without rclpy (logged on ``log``)."""
    if not use_ros:
        return False
    from thor_slam_tpu_torch.slam.adapters import ros_bridge

    if not ros_bridge.HAVE_ROS:
        log.error("--ros requested but rclpy is not installed")
    return not ros_bridge.HAVE_ROS


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


def build_rig(cfg, sources, rig_ext, imu_ext=None):
    from thor_slam_tpu_torch.camera.rig import CameraRig

    return CameraRig(
        sources,
        queue_size=cfg.rig_queue_size,
        rig_extrinsics=rig_ext,
        imu_extrinsics=imu_ext,
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

    try:
        sources, rig_ext, imu_ext = build_sources(cfg)
    except ImportError as e:  # depthai absent: say so, don't traceback
        logger.error("%s", e)
        return 2

    bus = MessageBus()
    pose_topic = bus.topic("/slam/pose", queue_size=30)
    stats = PipelineStats()
    ros_bridge = None
    if use_ros:
        if ros_missing(use_ros):
            return 2
        from thor_slam_tpu_torch.slam.adapters.ros_bridge import RosBridge

        ros_bridge = RosBridge()
    engine = build_engine(cfg, device)
    rig = build_rig(cfg, sources, rig_ext, imu_ext)

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
                if ros_bridge is not None:
                    ros_bridge.publish_pose(pose)
                    ros_bridge.publish_map_tf(engine.map_t_odom, pose.timestamp)

            if cfg.display:
                _display_frames(sync)

            now = time.monotonic()
            if now - last_status >= 2.0:  # the reference's cadence
                print(stats.status_line(frame_count), flush=True)
                last_status = now
                if ros_bridge is not None and pose is not None:
                    # The landmark / observation clouds at status cadence:
                    # the map changes at keyframe rate.
                    ros_bridge.publish_observations(
                        engine.get_map().to_point_cloud(), pose.timestamp
                    )
                    ros_bridge.publish_landmarks(
                        engine.get_landmark_cloud(), pose.timestamp
                    )
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
        if ros_bridge is not None:
            ros_bridge.shutdown()
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
    parser.add_argument(
        "--ros", action="store_true",
        help="Publish odometry/TF to ROS 2 (requires rclpy; reference topics)",
    )
    parser.add_argument("--device", default=None, help="Compute device (default: the current CUDA device)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")

    # Fail fast on operator mistakes before the config is read and the
    # engine comes up.
    if ros_missing(args.ros):
        return 2
    cfg, rc = load_run_config(args.config)
    if cfg is None:
        return rc
    if args.synthetic:
        cfg.synthetic.enabled = True

    signal.signal(signal.SIGINT, _handle_signal)
    signal.signal(signal.SIGTERM, _handle_signal)
    return run(cfg, max_frames=args.frames, save_map_path=args.save_map, use_ros=args.ros, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
