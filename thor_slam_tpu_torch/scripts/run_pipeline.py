"""Full pipeline runner: SLAM tracking + per-camera RGB-D product streams,
and optionally the in-process dense mapper.

Port of the JAX package's ``scripts/run_pipeline.py``: everything run_slam
does, plus dense SGM depth for the cameras listed in ``nvblox_cameras``
(or flagged ``enable_rgbd``; in synthetic mode the first source),
published as aligned (rgb, 16UC1-millimeter depth) pairs on bus topics
``/camera_{i}/rgb|depth``. With ``--map`` (or ``mapping.enabled``) a
:class:`~thor_slam_tpu_torch.pipeline.mapper.DenseMapper` on the same
device integrates each RGB-D frame where it was produced
(``fetch=False``), at the pose nearest in time. Sources are built as
``run_slam`` builds them (synthetic or hardware); ``--ros`` also publishes
the RGB-D streams (host copies, ``frame.fetched()``), the surface cloud and
the mesh. Everything runs on the card unless ``--device`` says otherwise.

Usage:
    python -m thor_slam_tpu_torch.scripts.run_pipeline --synthetic --frames 60 --rgbd-every 5
    python -m thor_slam_tpu_torch.scripts.run_pipeline --synthetic --map --frames 30 --device cpu
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import time

from thor_slam_tpu_torch.scripts import run_slam as rs

logger = logging.getLogger("run_pipeline")


def run(
    cfg,
    max_frames: int | None = None,
    rgbd_every: int = 5,
    use_ros: bool = False,
    save_dense_map: str | None = None,
    save_ply: str | None = None,
    device=None,
) -> int:
    """Run tracking, the RGB-D streams and the mapper; ``device=None`` is
    the card (raises without one), ``"cpu"`` the plain versions. Returns
    the exit code."""
    import numpy as np

    from thor_slam_tpu_torch.pipeline.bus import MessageBus
    from thor_slam_tpu_torch.pipeline.rgbd import RGBDProcessor
    from thor_slam_tpu_torch.slam.interface import SlamConfig
    from thor_slam_tpu_torch.utils.platform import select_device
    from thor_slam_tpu_torch.utils.profiling import PipelineStats, RateCounter

    device = select_device(device)
    try:
        sources, rig_ext, imu_ext = rs.build_sources(cfg)
    except ImportError as e:  # depthai absent: say so, don't traceback
        logger.error("%s", e)
        return 2

    bus = MessageBus()
    pose_topic = bus.topic("/slam/pose", queue_size=30)
    stats = PipelineStats()
    ros_bridge = None
    if use_ros:
        if rs.ros_missing(use_ros, logger):
            return 2
        from thor_slam_tpu_torch.slam.adapters.ros_bridge import RosBridge

        ros_bridge = RosBridge()
    engine = rs.build_engine(cfg, device)
    rig = rs.build_rig(cfg, sources, rig_ext, imu_ext)

    # RGB-D processors: explicit nvblox list, else enable_rgbd flags, else
    # (synthetic mode) the first camera.
    rgbd_ips = cfg.rgbd_camera_ips()
    if not rgbd_ips and (cfg.synthetic.enabled or not cfg.cameras):
        rgbd_ips = [sources[0].name]
    processors: list[RGBDProcessor] = []
    rgbd_topics = {}
    rgbd_fps: dict[str, RateCounter] = {}

    # In-process dense mapper: the nvblox-node role, on the same device.
    mapper = None
    pose_hist: list = []  # (timestamp, world_t_body) ring for TF-style lookup
    if cfg.mapping.enabled:
        from thor_slam_tpu_torch.pipeline.mapper import DenseMapper, MapperConfig

        m = cfg.mapping
        mapper = DenseMapper(
            MapperConfig(
                voxel_size_m=m.voxel_size_m,
                dims=m.dims,
                truncation_vox=m.truncation_vox,
                max_integration_distance_m=m.max_integration_distance_m,
                integrate_color=m.integrate_color,
                recenter_margin_m=m.recenter_margin_m,
                slice_axis=m.slice_axis,
                slice_band_m=m.slice_band_m,
                esdf_max_distance_m=m.esdf_max_distance_m,
            ),
            device=device,
        )
        logger.info(
            "Dense mapper: %s voxels at %.0f mm (%.1fx%.1fx%.1f m)",
            "x".join(map(str, m.dims)), m.voxel_size_m * 1000, *mapper.spec.extent_m,
        )
    surface_topic = bus.topic("/mapper/surface", queue_size=2, keep_latest_only=True)

    frame_count = 0
    try:
        rig.start()
        logger.info("Initializing engine...")
        engine.initialize(rig.calibration, SlamConfig(num_cameras=cfg.num_cameras, expected_fps=cfg.fps))

        cam_cfg_by_ip = {c.ip: c for c in cfg.cameras}
        product_ext: dict[str, object] = {}
        for i, ip in enumerate(rgbd_ips):
            src = rig.get_source(ip)
            if src is None:
                logger.warning("RGB-D camera %s not in the rig; skipping", ip)
                continue
            # Color leg + independent output resolution: any source exposing
            # the color surface feeds the color-aligned product.
            entry = cam_cfg_by_ip.get(ip)
            out_res = entry.rgb_output_resolution if entry is not None else None
            color_intr = getattr(src, "get_rgb_intrinsics", lambda: None)()
            color_ext = getattr(src, "get_rgb_extrinsics", lambda: None)()
            proc = RGBDProcessor(
                ip,
                src.get_intrinsics(),
                src.get_extrinsics(),
                output_resolution=out_res,
                color_intrinsics=color_intr,
                left_t_color=(
                    color_ext.to_4x4_matrix() if color_ext is not None else None
                ),
                device=device,
            )
            if proc.color_mode:
                out = proc.output_intrinsics
                logger.info("RGB-D %s: color-aligned at %dx%d", ip, out.width, out.height)
            # Pose of the RGB-D product frame in the body: body_T_left
            # composed with the product's frame (rectified-left or color).
            body_cams = rig.calibration.get_world_extrinsics(ip)
            if body_cams:
                product_ext[ip] = body_cams[0].to_4x4_matrix() @ proc.product_t_in_left
            processors.append(proc)
            rgbd_topics[ip] = (
                bus.topic(f"/camera_{i}/rgb", queue_size=5),
                bus.topic(f"/camera_{i}/depth", queue_size=5),
            )
            rgbd_fps[ip] = RateCounter()
            logger.info("RGB-D stream for %s -> /camera_%d/{rgb,depth}", ip, i)

        last_status = time.monotonic()
        while not rs._shutdown and (max_frames is None or frame_count < max_frames):
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
                pose_hist.append((pose.timestamp, pose.to_4x4_matrix()))
                if len(pose_hist) > 60:
                    del pose_hist[:-60]
                if ros_bridge is not None:
                    ros_bridge.publish_pose(pose)
                    ros_bridge.publish_map_tf(engine.map_t_odom, pose.timestamp)

            if frame_count % rgbd_every == 0:
                with stats.stage("rgbd").time():
                    for idx, proc in enumerate(processors):
                        color = None
                        if proc.color_mode:
                            src = rig.get_source(proc.camera_name)
                            color = getattr(src, "try_get_latest_rgb_frame", lambda: None)()
                        # Device-resident product: the mapper consumes it
                        # where the depth pipeline produced it; in-process
                        # bus subscribers call frame.fetched() for host bytes.
                        frame = proc.process(sync, color_frame=color, fetch=False)
                        if frame is not None:
                            rgb_t, depth_t = rgbd_topics[proc.camera_name]
                            rgb_t.publish(frame)
                            depth_t.publish(frame)
                            rgbd_fps[proc.camera_name].tick()
                            if ros_bridge is not None:
                                ros_bridge.publish_rgbd(idx, frame.fetched())
                            if (
                                mapper is not None
                                and pose_hist
                                and proc.camera_name in product_ext
                                and (frame_count // rgbd_every)
                                % cfg.mapping.integrate_every == 0
                            ):
                                # TF-style lookup: nearest pose by stamp (the
                                # pipelined engine's pose lags the frame).
                                ts, world_t_body = min(
                                    pose_hist, key=lambda p: abs(p[0] - frame.timestamp)
                                )
                                with stats.stage("map").time():
                                    mapper.integrate(
                                        frame,
                                        np.asarray(world_t_body)
                                        @ product_ext[proc.camera_name],
                                    )

            now = time.monotonic()
            if now - last_status >= 2.0:
                rates = " ".join(
                    f"rgbd[{ip[-2:]}]={r.rate_hz:.1f}Hz" for ip, r in rgbd_fps.items()
                )
                map_stat = ""
                if mapper is not None and mapper.stats.integrated_frames:
                    pts, cols = mapper.surface_cloud(max_points=65536)
                    surface_topic.publish((pts, cols))
                    if ros_bridge is not None:
                        ros_bridge.publish_surface_cloud(pts, cols, sync.timestamp)
                    map_stat = (
                        f" | map: {mapper.stats.integrated_frames}f"
                        f" {len(pts)}pts r{mapper.stats.recenters}"
                    )
                print(stats.status_line(frame_count) + " | " + rates + map_stat, flush=True)
                last_status = now
    finally:
        rig.stop()
        engine.flush()  # finalize the in-flight pipelined tick
        m = engine.get_map()
        print(
            f"Done: {frame_count} frames | map: {len(m.points)} points, "
            f"{len(m.keyframe_poses)} keyframes",
            flush=True,
        )
        if mapper is not None and mapper.stats.integrated_frames:
            mesh = mapper.mesh()
            dist, occ, obs, _ = mapper.esdf_slice()
            print(
                f"Dense map: {mapper.stats.integrated_frames} frames integrated | "
                f"mesh {len(mesh.vertices)}v/{len(mesh.triangles)}t | "
                f"costmap {int(occ.sum())} occupied / {int(obs.sum())} observed cells",
                flush=True,
            )
            if save_dense_map:
                mapper.save(save_dense_map)
                print(f"Dense map saved to {save_dense_map}", flush=True)
            if save_ply:
                mesh.save_ply(save_ply)
                print(f"Mesh PLY saved to {save_ply}", flush=True)
            if ros_bridge is not None:
                ros_bridge.publish_mesh_marker(mesh, time.time())
        engine.shutdown()
        if ros_bridge is not None:
            ros_bridge.shutdown()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default=None, help="YAML config path (needs pyyaml)")
    parser.add_argument("--synthetic", action="store_true", help="Force the synthetic rig")
    parser.add_argument("--frames", type=int, default=None, help="Stop after N frames")
    parser.add_argument("--rgbd-every", type=int, default=5, help="RGB-D cadence (ticks)")
    parser.add_argument(
        "--map", action="store_true",
        help="Enable the in-process dense mapper (TSDF/mesh/costmap — the "
        "nvblox-node role; also via config mapping.enabled)",
    )
    parser.add_argument(
        "--save-dense-map", default=None, metavar="PATH",
        help="On exit, save the TSDF grid (.npz; reload with DenseMapper.load)",
    )
    parser.add_argument(
        "--save-ply", default=None, metavar="PATH",
        help="On exit, export the Surface-Nets mesh as binary PLY",
    )
    parser.add_argument(
        "--ros", action="store_true",
        help="Publish odometry/TF + nvblox RGB-D topics to ROS 2 (requires rclpy)",
    )
    parser.add_argument("--device", default=None, help="Compute device (default: the current CUDA device)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")

    # Fail fast on operator mistakes before the engine comes up.
    if rs.ros_missing(args.ros, logger):
        return 2
    cfg, rc = rs.load_run_config(args.config)
    if cfg is None:
        return rc
    if args.synthetic:
        cfg.synthetic.enabled = True
    if args.map:
        cfg.mapping.enabled = True

    signal.signal(signal.SIGINT, rs._handle_signal)
    signal.signal(signal.SIGTERM, rs._handle_signal)
    if (args.save_dense_map or args.save_ply) and not cfg.mapping.enabled:
        logger.error("--save-dense-map/--save-ply require --map (or mapping.enabled)")
        return 2
    return run(
        cfg,
        max_frames=args.frames,
        rgbd_every=args.rgbd_every,
        use_ros=args.ros,
        save_dense_map=args.save_dense_map,
        save_ply=args.save_ply,
        device=args.device,
    )


if __name__ == "__main__":
    sys.exit(main())
