"""TorchSlamEngine: the SlamEngine backed by the PyTorch/CUDA tracker.

Synchronous multi-camera stereo SLAM, the reference ``TpuSlamEngine``'s
single-device, unpipelined mode with its default backends. Each
:meth:`process_frames`

1. attempts relocalization when it is armed (rate-limited);
2. ingests the tick's IMU samples and predicts the pose
   (:class:`~thor_slam_tpu_torch.engine.backends.ImuFusion`);
3. stages the rig tick, copies it to the device and runs one
   :func:`tracker.track_step` seeded with that prediction;
4. runs the host state machine of the reference's ``_finalize_values`` on
   the fetched outputs: held-pose covariance growth, the IMU shadow, the
   TrackingState machine, track-level bundle adjustment at keyframes
   (:class:`~thor_slam_tpu_torch.engine.backends.TrackBA`, corrections
   written into the live state), and the keyframe hook of loop closure
   (:class:`~thor_slam_tpu_torch.engine.backends.LoopBackend`, whose
   corrections compose into :attr:`map_t_odom`).

Every tick finalizes before the next is dispatched, so the reference's
correction-epoch lift of in-flight ticks has nothing to do here. Map
save/load, state checkpoints and relocalization live in
:mod:`~thor_slam_tpu_torch.engine.persistence`.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): pipelined mode, light ticks, multi-device tracking and mono sources.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from thor_slam_tpu import geometry
from thor_slam_tpu.camera.rig import RigCalibration
from thor_slam_tpu.camera.types import SynchronizedFrameSet
from thor_slam_tpu.slam.interface import (
    MapPoint,
    SlamConfig,
    SlamEngine,
    SlamMap,
    SlamPose,
    TrackingState,
)
from thor_slam_tpu_torch.engine import convert, persistence, staging
from thor_slam_tpu_torch.engine import tracker as trk
from thor_slam_tpu_torch.engine.backends import ImuFusion, LoopBackend, TrackBA
from thor_slam_tpu_torch.engine.backends.imu_fusion import IMU_NOISE_KEYS
from thor_slam_tpu_torch.engine.setup import build_camera_setup
from thor_slam_tpu_torch.utils import cuda_lib
from thor_slam_tpu_torch.utils.platform import pin_precision, select_device

logger = logging.getLogger(__name__)


class TorchSlamEngine(SlamEngine):
    """Multi-camera stereo SLAM on a CUDA device.

    The backend arguments and their defaults are the reference's
    (``TpuSlamEngine``): bundle adjustment, IMU fusion with the
    accelerometer term, and auto-relocalization are on; loop closure
    follows ``SlamConfig.enable_loop_closure`` (on by default).

    Args:
        params: Tracker parameter overrides (fields of
            :class:`~thor_slam_tpu_torch.engine.tracker.TrackerParams`;
            num_cams/height/width come from the calibration).
        lost_after: Consecutive low-inlier ticks before LOST.
        enable_ba: Track-level sliding-window bundle adjustment at every
            keyframe.
        ba_window, ba_landmarks, ba_tick_stride, ba_max_correction_m: The
            BA window's pose count, landmark slots, tick stride and junk
            guard (:class:`TrackBA`).
        use_imu: Seed each tick with the IMU pose prediction.
        use_accel: Full preintegrated translation once the online gravity
            estimate converges (requires ``use_imu``).
        gravity_min_ticks: Gravity observations before the accel term.
        imu_buffer_capacity: Raw IMU sample ring length.
        loop_db_capacity, loop_min_votes, loop_min_inliers,
        loop_exclude_recent, loop_cooldown_kfs, loop_min_correction_m,
        loop_noise_gate_sigma: Loop-closure parameters
            (:class:`LoopBackend`); the noise gate also gates BA.
        auto_relocalize: On LOST with a loaded map, arm relocalization.
        reloc_attempt_interval: While armed, attempt every N ticks.
        imu_noise: Noise-model overrides for :class:`ImuFusion`.
        device: Compute device; None means the current CUDA device (and
            raises without one). ``"cpu"`` runs the plain PyTorch versions
            of the kernels.
        seed: Seed of the tracker's RANSAC ``torch.Generator``.
        pipelined, light_ticks, devices: Reference modes not ported yet;
            pipelined/light ticks (ROADMAP Queue 1 #12) and more than one
            device (#15) raise ``NotImplementedError``.
    """

    def __init__(
        self,
        params: dict | None = None,
        lost_after: int = 5,
        enable_ba: bool = True,
        ba_window: int = 10,
        ba_landmarks: int = 384,
        ba_tick_stride: int = 2,
        ba_max_correction_m: float = 0.08,
        use_imu: bool = True,
        use_accel: bool = True,
        gravity_min_ticks: int = 30,
        imu_buffer_capacity: int = 256,
        loop_db_capacity: int = 256,
        loop_min_votes: int = 60,
        loop_min_inliers: int = 40,
        loop_exclude_recent: int = 12,
        loop_cooldown_kfs: int = 20,
        loop_min_correction_m: float = 0.05,
        loop_noise_gate_sigma: float = 3.0,
        auto_relocalize: bool = True,
        reloc_attempt_interval: int = 3,
        imu_noise: dict | None = None,
        device: str | torch.device | None = None,
        seed: int = 0,
        pipelined: bool = False,
        light_ticks: bool | None = None,
        devices: int | None = None,
    ) -> None:
        if pipelined:
            raise NotImplementedError("pipelined: pipelined mode (ROADMAP Queue 1 #12) is not ported yet")
        if light_ticks:
            raise NotImplementedError("light_ticks: light ticks (ROADMAP Queue 1 #12) are not ported yet")
        if devices not in (None, 1):
            raise NotImplementedError("devices > 1: multi-GPU tracking (ROADMAP Queue 1 #15)")
        if imu_noise and not set(imu_noise) <= IMU_NOISE_KEYS:
            raise ValueError(
                f"unknown imu_noise keys {sorted(set(imu_noise) - IMU_NOISE_KEYS)}; "
                f"valid: {sorted(IMU_NOISE_KEYS)}"
            )
        self._param_overrides = dict(params or {})
        self._lost_after = lost_after
        self._enable_ba = enable_ba
        self._use_imu = use_imu
        self._use_accel = bool(use_accel) and use_imu
        self._ba = TrackBA(
            window=ba_window,
            landmarks=ba_landmarks,
            tick_stride=ba_tick_stride,
            max_correction_m=ba_max_correction_m,
            noise_gate_sigma=loop_noise_gate_sigma,
        )
        self._imu = ImuFusion(
            use_accel=self._use_accel,
            gravity_min_ticks=gravity_min_ticks,
            capacity=imu_buffer_capacity,
            **(imu_noise or {}),
        )
        self._loop = LoopBackend(
            capacity=loop_db_capacity,
            min_votes=loop_min_votes,
            min_inliers=loop_min_inliers,
            exclude_recent=loop_exclude_recent,
            cooldown_kfs=loop_cooldown_kfs,
            min_correction_m=loop_min_correction_m,
            noise_gate_sigma=loop_noise_gate_sigma,
        )
        self._auto_reloc = bool(auto_relocalize)
        self._reloc_interval = max(1, int(reloc_attempt_interval))
        self._device_arg = device
        self._seed = seed
        self._config = SlamConfig()
        self._state_enum = TrackingState.NOT_INITIALIZED
        self._device: torch.device | None = None
        self._params: trk.TrackerParams | None = None
        self._setup: trk.CameraSetup | None = None
        self._tracker_state: trk.TrackerState | None = None
        self._generator: torch.Generator | None = None
        self._source_order: list[str] = []
        self._zero_img: np.ndarray | None = None
        #: Per-tick diagnostics of the last processed tick.
        self.last_diagnostics: dict = {}
        self._clear_host_state()

    def _clear_host_state(self) -> None:
        self._keyframe_poses: list[SlamPose] = []
        self._low_inlier_streak = 0
        self._held_cov: np.ndarray | None = None
        self._last_timestamp: float | None = None
        self._frame_count = 0
        self._want_reloc = False
        self._reloc_countdown = 0
        self._map_loaded = False
        #: map<-odom correction accumulated by loop closures; everything the
        #: engine returns as map data is lifted through it.
        self._map_t_odom = np.eye(4)
        #: odom-frame correction accumulated by BA (the IMU shadow's epoch,
        #: replaced and never mutated).
        self._ba_corr_total = np.eye(4)
        self._ba.clear()
        self._imu.reset()
        self._loop.reset()

    # ------------------------------------------------------------- setup

    def initialize(self, calibration: RigCalibration, config: SlamConfig | None = None) -> None:
        if config is not None:
            self._config = config
        setup_np, self._source_order, height, width = build_camera_setup(calibration)
        if calibration.imu_extrinsics is not None:
            ext = calibration.imu_extrinsics.extrinsics
            self._imu.body_r_imu = np.asarray(ext.rotation, np.float64)
            lever = float(np.linalg.norm(np.asarray(ext.translation, np.float64)))
            if self._use_accel and lever > 0.05:
                # With a lever arm the accelerometer also measures the
                # centripetal/tangential terms, which the accel path ignores.
                logger.warning(
                    "use_accel with a %.0f cm IMU lever arm: centripetal/tangential terms are "
                    "uncompensated — expect accel-prediction bias under fast rotation",
                    lever * 100.0,
                )
        self._params = trk.TrackerParams(
            num_cams=len(self._source_order), height=height, width=width, **self._param_overrides
        )
        self._device = select_device(self._device_arg)
        pin_precision()
        if self._device.type == "cuda":
            cuda_lib.load()  # build the kernels now, not on the first tick
        self._setup = convert.setup_to_torch(setup_np, self._device)
        self._ba.bind(self._setup, self._params.num_cams)
        self._loop.bind(self._setup, self._params.max_keypoints)
        # One-time solver and transform set-up here, not in a tick.
        if self._enable_ba:
            self._ba.warm()
        if self._config.enable_loop_closure:
            self._loop.warm()
        self._zero_img = np.zeros((height, width), np.uint8)
        self.reset()
        self._state_enum = TrackingState.INITIALIZING
        logger.info(
            "TorchSlamEngine initialized: %d cams @ %dx%d on %s (BA %s, IMU %s, loop closure %s)",
            self._params.num_cams, width, height, self._device,
            self._enable_ba, self._use_imu, self._config.enable_loop_closure,
        )

    # ------------------------------------------------------------ tracking

    def process_frames(self, frame_set: SynchronizedFrameSet) -> SlamPose | None:
        if self._tracker_state is None:
            raise RuntimeError("initialize() must be called before process_frames()")
        if self._want_reloc:
            # Rate-limited: each attempt is a synchronous find + verify.
            if self._reloc_countdown > 0:
                self._reloc_countdown -= 1
            elif persistence.attempt_relocalization(self, frame_set):
                self._want_reloc = False
                self._reloc_countdown = 0
            else:
                self._reloc_countdown = self._reloc_interval - 1

        prediction = None
        if self._use_imu and frame_set.sensor_data is not None:
            self._imu.ingest(frame_set.sensor_data, frame_set.sensor_timestamp)
            prediction = self._imu.predict(frame_set.timestamp)

        host = staging.stage_images(frame_set, self._source_order, self._zero_img)
        images = torch.from_numpy(host).to(self._device)
        cam_active = None
        if frame_set.stale_sources:
            cam_active = torch.tensor(
                [name not in frame_set.stale_sources for name in self._source_order],
                device=self._device,
            )
        self._tracker_state, out = trk.track_step(
            self._params, self._setup, self._tracker_state, images,
            generator=self._generator, cam_active=cam_active,
            pose_prediction=None if prediction is None else torch.from_numpy(prediction).to(self._device),
        )
        vals = trk.unpack_output(trk.pack_output(out))
        tick = {
            "ts": frame_set.timestamp,
            "stale_sources": frame_set.stale_sources,
            "pred": prediction,
            # Packed before BA writes into the state, fetched on demand: BA
            # reads the observations of the ticks it collects, loop closure
            # the signature of keyframes.
            "ba_obs": trk.pack_ba_obs(out, self._tracker_state.lm_pos_w) if self._enable_ba else None,
            "kf_sig": (
                trk.pack_kf_sig(self._tracker_state)
                if self._config.enable_loop_closure and vals["refreshed"]
                else None
            ),
        }
        return self._finalize(vals, tick)

    def _finalize(self, vals: dict, tick: dict) -> SlamPose | None:
        """Host state machine for one tick, given the fetched outputs."""
        # A lookup dispatched at an earlier keyframe resolves here.
        self._poll_loop()
        world_t_body = vals["world_t_body"]
        num_inliers = vals["num_inliers"]
        refreshed = vals["refreshed"]
        covariance = vals["covariance"]
        ts = tick["ts"]
        min_inl = self._params.min_track_inliers

        pred_err = None
        if tick["pred"] is not None:
            pred_err = float(np.linalg.norm(np.asarray(tick["pred"], np.float64)[:3, 3] - world_t_body[:3, 3]))

        # A HELD pose (solve lacked support) grows the last trusted
        # covariance by the prediction's own uncertainty instead of quoting
        # the meaningless low-inlier solve covariance.
        if num_inliers < min_inl and self._frame_count >= 1 and self._held_cov is not None:
            dt = ts - self._last_timestamp if self._last_timestamp is not None else 1.0 / 30.0
            covariance = self._held_cov + self._imu.window_covariance(dt)
        self._held_cov = np.asarray(covariance, np.float64)

        diag = {
            "num_inliers": num_inliers,
            "num_landmarks": vals["num_landmarks"],
            "rms_error": vals["rms_error"],
            "refreshed": refreshed,
            "stale_sources": sorted(tick["stale_sources"]),
        }
        if pred_err is not None:
            diag["imu_pred_err_m"] = pred_err
        if self._use_imu and self._imu.estimate_gyro_bias:
            diag["gyro_bias_rad_s"] = float(np.linalg.norm(self._imu.gyro_bias))
        if self._use_accel:
            diag["accel_pred"] = self._imu.accel_pred_active()
            if self._imu.gravity_w is not None:
                diag["gravity_norm"] = float(np.linalg.norm(self._imu.gravity_w))
        self.last_diagnostics = diag

        self._imu.on_finalized(world_t_body, ts, tracked=num_inliers >= min_inl, epoch=self._ba_corr_total)
        self._last_timestamp = ts
        self._frame_count += 1

        if self._frame_count <= 1:
            self._state_enum = TrackingState.INITIALIZING
        elif num_inliers >= min_inl:
            self._state_enum = TrackingState.TRACKING
            self._low_inlier_streak = 0
        else:
            self._low_inlier_streak += 1
            if self._state_enum == TrackingState.LOST:
                self._state_enum = TrackingState.RELOCALIZING
            elif self._low_inlier_streak >= self._lost_after:
                self._state_enum = TrackingState.LOST
                if self._auto_reloc and self._map_loaded and self._loop.db:
                    self._want_reloc = True
                    self._reloc_countdown = 0

        if self._enable_ba:
            tracked_now = num_inliers >= min_inl and self._frame_count > 1
            if tracked_now and (refreshed or self._frame_count % self._ba.tick_stride == 0):
                self._ba.push_tick(tick["ba_obs"], world_t_body, ts, refreshed)
            elif refreshed:
                # A refresh while untracked is a VO restart: fresh ids, the
                # old window cannot join.
                self._ba.clear()
            if refreshed and self._state_enum == TrackingState.TRACKING:
                self._tracker_state, world_t_body, t_corr = self._ba.run(
                    world_t_body, covariance, self._tracker_state, self.last_diagnostics
                )
                if t_corr is not None:
                    self._ba_corr_total = t_corr @ self._ba_corr_total
                    self._imu.on_correction(world_t_body, t_corr, self._ba_corr_total)

        if refreshed and self._state_enum == TrackingState.TRACKING:
            map_pose = self._map_t_odom @ world_t_body
            self._keyframe_poses.append(SlamPose.from_4x4_matrix(map_pose, timestamp=ts))
            if self._config.enable_loop_closure and tick["kf_sig"] is not None:
                self._loop.on_keyframe(
                    map_pose, ts, trk.unpack_kf_sig(tick["kf_sig"]), self._map_t_odom, self._frame_count
                )
            if len(self._keyframe_poses) > 10000:
                self._keyframe_poses = self._keyframe_poses[-10000:]

        # The returned pose is the smooth odometry-frame estimate; the
        # loop-corrected one is map_t_odom @ pose (get_world_pose).
        # Confidence is the reference's 1 / (1 + trace) of the covariance.
        pose = SlamPose.from_4x4_matrix(
            world_t_body,
            timestamp=ts,
            tracking_state=self._state_enum,
            confidence=float(1.0 / (1.0 + np.trace(covariance))),
        )
        pose.covariance = covariance
        if self._state_enum == TrackingState.LOST and num_inliers < min_inl // 2:
            return None
        return pose

    def _poll_loop(self, block: bool = False) -> None:
        """Advance the loop-closure machine. A closure applies map side
        only: it composes into map_t_odom and rewrites the keyframe tail
        with the pose graph's trajectory; the live tracker is untouched."""
        res = self._loop.poll(block=block, diagnostics=self.last_diagnostics)
        if res is None:
            return
        t_corr, opt_poses, kk, _ = res
        n_kf = min(len(self._keyframe_poses), kk)
        for j in range(n_kf):
            old = self._keyframe_poses[-n_kf + j]
            self._keyframe_poses[-n_kf + j] = SlamPose.from_4x4_matrix(
                opt_poses[kk - n_kf + j], timestamp=old.timestamp
            )
        self._map_t_odom = t_corr @ self._map_t_odom

    def flush(self) -> SlamPose | None:
        """Drain a loop detection still in flight (stream end). Ticks are
        synchronous, so no pose is pending."""
        self._poll_loop(block=True)
        return None

    def get_tracking_state(self) -> TrackingState:
        return self._state_enum

    @property
    def map_t_odom(self) -> np.ndarray:
        """(4, 4) map<-odom correction accumulated by loop closures."""
        return self._map_t_odom.copy()

    def get_world_pose(self, pose: SlamPose) -> SlamPose:
        """Lift an odometry-frame pose into the loop-corrected map frame."""
        lifted = SlamPose.from_4x4_matrix(
            self._map_t_odom @ pose.to_4x4_matrix(),
            timestamp=pose.timestamp,
            tracking_state=pose.tracking_state,
            confidence=pose.confidence,
        )
        if pose.covariance is not None:
            lifted.covariance = geometry.rotate_cov6(self._map_t_odom[:3, :3], pose.covariance)
        return lifted

    @property
    def loops_closed(self) -> int:
        return self._loop.loops_closed

    @property
    def imu_empty_windows(self) -> int:
        """IMU preintegration windows that held no samples (growth while
        ``use_imu`` is on means the IMU path is dead)."""
        return self._imu.empty_windows

    # ------------------------------------------------------------ mapping

    def get_map(self) -> SlamMap:
        """Keyframe poses plus the live landmark bank, in the map frame."""
        if self._tracker_state is None:
            return SlamMap()
        pos = self._tracker_state.lm_pos_w.detach().cpu().numpy().astype(np.float64).reshape(-1, 3)
        valid = self._tracker_state.lm_valid.detach().cpu().numpy().reshape(-1)
        m = self._map_t_odom
        points = [MapPoint(position=p) for p in pos[valid] @ m[:3, :3].T + m[:3, 3]]
        if self._config.max_map_size and len(points) > self._config.max_map_size:
            points = points[: self._config.max_map_size]
        return SlamMap(
            points=points,
            keyframe_poses=list(self._keyframe_poses),
            timestamp=self._last_timestamp or 0.0,
        )

    def get_landmark_cloud(self) -> np.ndarray:
        return persistence.get_landmark_cloud(self)

    def save_map(self, path: str) -> bool:
        return persistence.save_map(self, path)

    def load_map(self, path: str) -> bool:
        return persistence.load_map(self, path)

    def save_state(self, path: str) -> bool:
        return persistence.save_state(self, path)

    def load_state(self, path: str) -> bool:
        return persistence.load_state(self, path)

    def relocalize(self) -> bool:
        return persistence.relocalize(self)

    # ------------------------------------------------------------ lifecycle

    def reset(self) -> None:
        if self._params is not None:
            self._tracker_state = trk.init_state(self._params, self._device)
            self._generator = torch.Generator(device=self._device).manual_seed(self._seed)
        self._clear_host_state()
        if self._state_enum != TrackingState.NOT_INITIALIZED:
            self._state_enum = TrackingState.INITIALIZING

    def shutdown(self) -> None:
        self._tracker_state = None
        self._state_enum = TrackingState.NOT_INITIALIZED
