"""TorchSlamEngine: the SlamEngine backed by the PyTorch/CUDA tracker.

Multi-camera SLAM on one device or a mesh of them, with the reference
``TpuSlamEngine``'s backends and modes, on stereo, mixed (stereo + mono)
and all-mono rigs.
Each :meth:`process_frames`

1. asks the light-tick scheduler (:class:`~thor_slam_tpu_torch.engine.
   backends.LightController`) whether this tick ships the left images
   only, and at half resolution;
2. stages the tick (:func:`staging.stage_images`) and copies it to the
   device: at once when synchronous; when ``pipelined``, on the uploader's
   worker thread through pinned buffers and a copy stream
   (:class:`~thor_slam_tpu_torch.pipeline.transfer.DoubleBufferedUploader`)
   while the oldest in-flight tick is finalized;
3. dispatches the tick (:meth:`_dispatch_tick`): a relocalization attempt
   when armed (rate-limited; every in-flight tick is finalized first), the
   IMU prediction (:class:`~thor_slam_tpu_torch.engine.backends.
   ImuFusion`), one :data:`tracker.track_step_graphed` (the tick replayed
   from CUDA graphs on a card; the sharded step of
   :mod:`~thor_slam_tpu_torch.parallel.mesh` with ``devices`` > 1), the
   packing of its fresh
   outputs and their device-to-host copies into pinned memory behind one
   event; on an all-mono rig without a map, the two-view bootstrap
   (:func:`tracker.mono_init`, every other tick, one 4-float readback an
   attempt);
4. finalizes ticks (:meth:`_finalize_values`, the reference's
   ``_finalize_values``) in dispatch order: the correction-epoch lift of a
   tick dispatched before a BA correction, held-pose covariance growth,
   the IMU shadow, the TrackingState machine, track-level bundle
   adjustment at keyframes (:class:`~thor_slam_tpu_torch.engine.backends.
   TrackBA`, corrections written into the newest live state), the keyframe
   hook of loop closure (:class:`~thor_slam_tpu_torch.engine.backends.
   LoopBackend`, whose corrections compose into :attr:`map_t_odom`).

Synchronous, a tick finalizes within its own call. Pipelined, the
in-flight records live in a :class:`~thor_slam_tpu_torch.engine.
pipeline_exec.PipelineExecutor`: ``process_frames`` returns the pose of the
tick ``pipeline_depth`` calls back (None while the pipeline fills) and
:meth:`flush` the last one; under ``defer_sync`` nothing is finalized
until :meth:`flush`, which replays the whole stream
(:attr:`last_flush_poses`). A full tick waits for the device once, on its
keyframe flag, so the pipeline runs ahead of the device across light
ticks only; the IMU prediction and the live cameras reach the step from
pinned memory, without a wait.
Map save/load, state checkpoints and relocalization live in
:mod:`~thor_slam_tpu_torch.engine.persistence`.

An all-mono rig's odometry is up to scale (the bootstrap fixes a unit
translation between its two views), so the metric subsystems are switched
off for it at :meth:`initialize`: window BA, and the accelerometer term of
the IMU prediction (the gyro's rotation prediction stays).

With ``devices`` > 1 one process drives a mesh of shards (cameras when
they divide the mesh, landmark slots otherwise): the state is a
:class:`~thor_slam_tpu_torch.parallel.mesh.ShardedTrackerState`, which the
host backends read as the full state, light ticks are off, and the
pipelined uploader's one staged buffer is copied to each shard by the step.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from thor_slam_tpu_torch import geometry
from thor_slam_tpu_torch.camera.rig import RigCalibration
from thor_slam_tpu_torch.camera.types import SynchronizedFrameSet
from thor_slam_tpu_torch.slam.interface import (
    MapPoint,
    SlamConfig,
    SlamEngine,
    SlamMap,
    SlamPose,
    TrackingState,
)
from thor_slam_tpu_torch.engine import convert, persistence, staging
from thor_slam_tpu_torch.engine import tracker as trk
from thor_slam_tpu_torch.engine.backends import ImuFusion, LightController, LoopBackend, TrackBA
from thor_slam_tpu_torch.engine.backends.imu_fusion import IMU_NOISE_KEYS
from thor_slam_tpu_torch.engine.pipeline_exec import PipelineExecutor
from thor_slam_tpu_torch.engine.setup import build_camera_setup
from thor_slam_tpu_torch.parallel import mesh as mesh_mod
from thor_slam_tpu_torch.pipeline.transfer import DoubleBufferedUploader
from thor_slam_tpu_torch.utils import cuda_lib, profiling
from thor_slam_tpu_torch.utils.platform import pin_precision, select_device

logger = logging.getLogger(__name__)


def _empty_upload_stats() -> dict:
    return {"full": 0, "light": 0, "light_half": 0, "bytes": 0}


class TorchSlamEngine(SlamEngine):
    """Multi-camera SLAM on a CUDA device.

    The arguments and their defaults are the reference's
    (``TpuSlamEngine``): bundle adjustment, IMU fusion with the
    accelerometer term, auto-relocalization, light ticks (one device) and
    the adaptive half-resolution controller are on; loop
    closure follows ``SlamConfig.enable_loop_closure`` (on by default).

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
        prewarm_degraded: The reference compiles its step's masked-camera
            variant at ``initialize``. Here it runs the ``cam_active`` path
            once, on a throwaway state, at ``initialize`` (on a card the
            tick's graphs, which do not depend on the mask, are captured
            there for every variant in any case).
        pipelined: Overlap staging, upload and finalize with device compute:
            ``process_frames(k)`` returns the pose of tick k - depth (None
            while the pipeline fills); :meth:`flush` returns the last.
        pipeline_depth: In-flight ticks when ``pipelined`` (>= 1). Every
            backend runs at any depth: each consumes finalized ticks only,
            and a tick dispatched before a BA correction is lifted into
            the corrected frame at its finalize.
        defer_sync: Dataset replay (needs ``pipelined``; BA and the IMU
            off): nothing is finalized until :meth:`flush`, which replays
            the stream; ``process_frames`` returns None and
            :attr:`last_flush_poses` holds every tick's pose. Loop closure
            is switched off (it needs finalized keyframes mid-stream).
        devices: Track over N devices (:mod:`~thor_slam_tpu_torch.
            parallel.mesh`): ``cuda:0`` .. ``cuda:N-1`` (``initialize``
            raises ``RuntimeError`` when fewer are visible), or N virtual
            shards with ``device="cpu"``. A sequence of devices is the
            mesh as given, repeats included (N shards on one card). The
            axis is the cameras when they divide N, the landmark slots
            otherwise; mono sources are refused at ``initialize``.
        light_ticks: Ship the left images only on ticks the host predicts
            will not keyframe (:class:`LightController`); None means on
            for one device unless ``defer_sync``.
        light_max_interval: A full tick at least every N ticks.
        light_half_res: Light ticks ship 2x2-mean half-resolution images,
            upsampled on the device (needs even frame dimensions).
        adaptive_half_res: Degrade light ticks to half resolution while the
            busy time per tick stays over the camera period on a stream
            paced in real time, and restore with hysteresis. None means on.
            (The reference's None also reads an environment variable that
            spares its CPU test suite a second compile; nothing is compiled
            here, so no variable is read.)
        auto_relocalize: On LOST with a loaded map, arm relocalization.
        reloc_attempt_interval: While armed, attempt every N ticks.
        imu_noise: Noise-model overrides for :class:`ImuFusion`.
        device: Compute device; None means the current CUDA device (and
            raises without one). ``"cpu"`` runs the plain PyTorch versions
            of the kernels.
        seed: Seed of the tracker's RANSAC ``torch.Generator``.
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
        prewarm_degraded: bool = False,
        pipelined: bool = False,
        pipeline_depth: int = 1,
        defer_sync: bool = False,
        devices: int | None = None,
        light_ticks: bool | None = None,
        light_max_interval: int = 4,
        light_half_res: bool = False,
        adaptive_half_res: bool | None = None,
        auto_relocalize: bool = True,
        reloc_attempt_interval: int = 3,
        imu_noise: dict | None = None,
        device: str | torch.device | None = None,
        seed: int = 0,
    ) -> None:
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if defer_sync and not pipelined:
            raise ValueError("defer_sync requires pipelined=True")
        if defer_sync:
            # Nothing finalizes mid-stream, so no backend that consumes
            # finalized ticks (the IMU shadow, the BA window) can run.
            if enable_ba:
                raise ValueError("defer_sync is incompatible with enable_ba")
            if use_imu:
                raise ValueError("defer_sync is incompatible with use_imu")
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
        self._prewarm_degraded = prewarm_degraded
        self._pipelined = pipelined
        self._pipeline_depth = pipeline_depth
        self._defer_sync = defer_sync
        self._uploader: DoubleBufferedUploader | None = None
        #: In-flight tick records. Late-bound callbacks, so shims that wrap
        #: the engine's methods see every call.
        self._pending_q = PipelineExecutor(
            pipeline_depth, defer_sync,
            fetch=lambda recs: self._fetch_records(recs),
            finalize=lambda rec: self._finalize_values(rec),
        )
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
            # The prediction window spans `depth` ticks of samples.
            pred_capacity=64 * max(1, pipeline_depth),
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
        self._light_ctl = LightController(
            light_ticks, light_half_res, True if adaptive_half_res is None else adaptive_half_res, light_max_interval
        )
        self._auto_reloc = bool(auto_relocalize)
        self._reloc_interval = max(1, int(reloc_attempt_interval))
        self._device_arg = device
        self._devices_arg = devices
        self._n_devices = int(devices or 1) if isinstance(devices, (int, type(None))) else len(devices)
        self._mesh = None  # resolved at initialize()
        self._step = None
        self._seed = seed
        self._config = SlamConfig()
        self._state_enum = TrackingState.NOT_INITIALIZED
        self._device: torch.device | None = None
        self._params: trk.TrackerParams | None = None
        self._setup: trk.CameraSetup | None = None
        self._tracker_state: trk.TrackerState | None = None
        self._generator: torch.Generator | list[torch.Generator] | None = None  # a list on a mesh
        self._source_order: list[str] = []
        self._zero_img: np.ndarray | None = None
        self._all_mono = False  # resolved at initialize()
        #: Per-tick diagnostics of the last finalized tick.
        self.last_diagnostics: dict = {}
        #: Staged ticks by class and staged image bytes since
        #: initialize()/reset().
        self.upload_stats: dict = _empty_upload_stats()
        #: Per-tick poses of the last defer_sync flush, in stream order
        #: (None where tracking was LOST).
        self.last_flush_poses: list[SlamPose | None] = []
        #: Ticks dispatched over the engine's life: the next one's number (a
        #: record's "tick", the tracer's tick id; never reset).
        self._ticks_dispatched = 0
        self._clear_host_state()

    def _clear_host_state(self) -> None:
        self._pending_q.clear()
        self._close_uploader()
        self._keyframe_poses: list[SlamPose] = []
        self._low_inlier_streak = 0
        self._held_cov: np.ndarray | None = None
        self._last_timestamp: float | None = None
        self._frame_count = 0
        self._want_reloc = False
        self._reloc_countdown = 0
        self._map_loaded = False
        self._mono_boot_done = False
        self._mono_boot_countdown = 2  # KLT needs a couple of frames first
        self._mono_rearm_after = 0
        #: Host shadow of the device's keyframe pose (the light scheduler
        #: measures the motion since it).
        self._last_kf_odom: np.ndarray | None = None
        #: map<-odom correction accumulated by loop closures; everything the
        #: engine returns as map data is lifted through it.
        self._map_t_odom = np.eye(4)
        #: odom-frame correction accumulated by BA, written into the live
        #: state as it lands. Each record keeps the value at its dispatch
        #: (its "corr_epoch"); replaced, never mutated.
        self._ba_corr_total = np.eye(4)
        self.upload_stats = _empty_upload_stats()
        self._ba.clear()
        self._imu.reset()
        self._loop.reset()
        self._light_ctl.reset()

    def _close_uploader(self) -> None:
        if self._uploader is not None:
            self._uploader.close()
            self._uploader = None

    # ------------------------------------------------------------- setup

    def initialize(self, calibration: RigCalibration, config: SlamConfig | None = None) -> None:
        if config is not None:
            self._config = config
        if self._defer_sync and self._config.enable_loop_closure:
            logger.warning("defer_sync: disabling loop closure (no mid-stream finalize)")
            self._config = dataclasses.replace(self._config, enable_loop_closure=False)
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
        has_mono = not bool(setup_np.stereo_mask.all())
        if has_mono and self._n_devices > 1:
            raise RuntimeError(
                "mono sources are not supported under SPMD (devices > 1): "
                "cross-camera landmark seeding needs the full keyframe bank"
            )
        self._all_mono = has_mono and not bool(setup_np.stereo_mask.any())
        if self._all_mono:
            if self._enable_ba:
                logger.warning("all-mono rig: window BA disabled (monocular scale gauge)")
                self._enable_ba = False
            if self._use_accel:
                logger.warning(
                    "all-mono rig: accel translation prediction disabled "
                    "(up-to-scale odometry); gyro rotation prediction stays"
                )
                self._use_accel = False
                self._imu.use_accel = False
        self._params = trk.TrackerParams(
            num_cams=len(self._source_order), height=height, width=width,
            has_mono=has_mono, mono_bootstrap=self._all_mono, **self._param_overrides,
        )
        self._device = select_device(self._device_arg)
        if self._n_devices > 1:
            self._mesh = self._make_mesh()
            self._device = self._mesh.devices[0]
        pin_precision()
        if self._device.type == "cuda":
            cuda_lib.load()  # build the kernels now, not on the first tick
        self._setup = convert.setup_to_torch(setup_np, self._device)
        if self._mesh is not None:
            axis_mode = mesh_mod.choose_axis(self._params.num_cams, self._params.max_keypoints, self._n_devices)
            self._step = mesh_mod.make_sharded_track_step(self._params, self._setup, self._mesh, axis_mode)
            logger.info("SPMD tracking over %d devices (%s-sharded)", self._n_devices, axis_mode)
        self._ba.bind(self._setup, self._params.num_cams, mono_obs_weight=self._params.mono_obs_weight)
        self._loop.bind(self._setup, self._params.max_keypoints)
        # Light-tick scheduling and the adaptive controller.
        light_variants = self._light_ctl.resolve(
            self._n_devices, self._defer_sync, height, width, getattr(self._config, "expected_fps", 0.0) or 0.0
        )
        # One-time solver and transform set-up here, not in a tick.
        if self._enable_ba:
            self._ba.warm()
        if self._config.enable_loop_closure:
            self._loop.warm()
        self._zero_img = np.zeros((height, width), np.uint8)
        if self._mesh is None and self._device.type == "cuda":
            self._capture_variants(light_variants, height, width)
        if self._prewarm_degraded:
            # The masked-camera path once, on a throwaway state and draws.
            self._track(
                self._fresh_state(),
                torch.zeros((self._params.num_cams, 2, height, width), dtype=torch.uint8, device=self._device),
                self._fresh_generator(),
                cam_active=torch.ones(self._params.num_cams, dtype=torch.bool, device=self._device),
            )
        self.reset()
        self._state_enum = TrackingState.INITIALIZING
        logger.info(
            "TorchSlamEngine initialized: %d cams @ %dx%d on %s (BA %s, IMU %s, loop closure %s, "
            "pipelined %s depth %d, light ticks %s)",
            self._params.num_cams, width, height, self._device, self._enable_ba, self._use_imu,
            self._config.enable_loop_closure, self._pipelined, self._pipeline_depth, self._light_ctl.light,
        )

    def _capture_variants(self, light_variants: list[bool], height: int, width: int) -> None:
        """Capture the graphed tick of every variant a tick can take (full,
        and each light variant: half-res or not; each with and without the
        IMU's prediction), as the reference compiles its step's, so that no
        tick captures one (the adaptive controller switches to half-res
        mid-stream). Dry ticks on a throwaway state and generator: no
        hand-written kernel launches."""
        c = self._params.num_cams
        shapes = [((c, 2, height, width), False)]
        shapes += [((c, 1, height // 2, width // 2) if half else (c, 1, height, width), half) for half in light_variants]
        preds = [None] + ([self._host_tensor(np.eye(4, dtype=np.float32))] if self._use_imu else [])
        for shape, half in shapes:
            for pred in preds:
                trk.track_step_graphed.capture(
                    self._params, self._setup, self._fresh_state(),
                    torch.zeros(shape, dtype=torch.uint8, device=self._device), generator=self._fresh_generator(),
                    pose_prediction=pred, allow_refresh=shape[1] == 2, half_res=half,
                )

    def _make_mesh(self) -> mesh_mod.Mesh:
        """The mesh of ``devices``: as given, N virtual shards on the
        CPU, or the first N CUDA devices (``RuntimeError`` when fewer are
        visible)."""
        if not isinstance(self._devices_arg, int):
            return mesh_mod.make_camera_mesh(devices=self._devices_arg)
        if self._device.type == "cpu":
            return mesh_mod.make_camera_mesh(self._n_devices, "cpu")
        return mesh_mod.make_camera_mesh(self._n_devices)

    def _fresh_state(self):
        """A new tracker state, sharded over the mesh if there is one."""
        return self._place_state(trk.init_state(self._params, self._device))

    def _place_state(self, state: trk.TrackerState):
        """A full-size state as the engine holds it (sharded on a mesh)."""
        if self._mesh is None:
            return state
        return mesh_mod.shard_state(state, self._mesh, self._step.axis_mode)

    def _fresh_generator(self):
        """The RANSAC draws' generator (one per shard on a mesh)."""
        if self._mesh is None:
            return torch.Generator(device=self._device).manual_seed(self._seed)
        return mesh_mod.shard_generators(self._mesh, self._seed)

    def _track(self, state, images, generator, cam_active=None, pose_prediction=None, light=False, half=False):
        """One step of the tracker: ``track_step_graphed``, or the sharded step."""
        if self._mesh is None:
            return trk.track_step_graphed(
                self._params, self._setup, state, images, generator=generator, cam_active=cam_active,
                pose_prediction=pose_prediction, allow_refresh=not light, half_res=half,
            )
        return self._step(state, images, generators=generator, cam_active=cam_active, pose_prediction=pose_prediction)

    # ------------------------------------------------------------ tracking

    def process_frames(self, frame_set: SynchronizedFrameSet) -> SlamPose | None:
        if self._tracker_state is None:
            raise RuntimeError("initialize() must be called before process_frames()")
        with profiling.span("engine.process_frames", tick=self._ticks_dispatched, frame_ts=frame_set.timestamp):
            t_in = time.perf_counter() if self._light_ctl.adaptive else None
            light = self._schedule_light()
            half = light and self._light_ctl.half_active
            profiling.annotate(light=light, half=half)
            if not self._pipelined:
                images = torch.from_numpy(self._stage(frame_set, light, half)).to(self._device)
                pose = self._finalize_tick(self._dispatch_tick(images, frame_set, light, half))
            else:
                # Stage and upload tick k on the uploader's thread while the
                # host finalizes the oldest in-flight tick.
                if self._uploader is None:
                    self._uploader = DoubleBufferedUploader(
                        lambda item, alloc: self._stage(*item, alloc=alloc), self._device,
                        slots=self._pipeline_depth + 1,
                    )
                self._uploader.submit((frame_set, light, half))
                pose = None
                if not self._defer_sync and self._pending_q.at_depth:
                    pose = self._pending_q.finalize_ready()
                images = self._uploader.get()
                self._pending_q.submit(self._dispatch_tick(images, frame_set, light, half))
            if t_in is not None:
                t_out = time.perf_counter()
                self._light_ctl.on_tick(t_out - t_in, frame_set.timestamp, t_out)
            profiling.annotate(state=self._state_enum.name)
            return pose

    def _stage(self, frame_set: SynchronizedFrameSet, light: bool, half: bool, alloc=None) -> np.ndarray:
        return staging.stage_images(
            frame_set, self._source_order, self._zero_img, light=light, half=half, alloc=alloc,
            stats=self.upload_stats, controller=self._light_ctl,
        )

    def _schedule_light(self) -> bool:
        """Light (left-only) or full tick for the next dispatch: the
        LightController's policy over the finalized state."""
        return self._light_ctl.schedule(
            frame_count=self._frame_count,
            want_reloc=self._want_reloc,
            tracking=self._state_enum == TrackingState.TRACKING,
            num_inliers=self.last_diagnostics.get("num_inliers", 0),
            params=self._params,
            fin_pose=self._imu.fin_pose,
            last_kf_odom=self._last_kf_odom,
        )

    @property
    def light_half_active(self) -> bool:
        """True while light ticks ship half-res (forced or adaptive)."""
        return bool(self._light_ctl.half_active)

    #: Record keys of the tick's outputs brought to the host, in order.
    _FETCH_KEYS = ("packed", "ba_obs", "kf_sig")

    def _dispatch_tick(self, images: torch.Tensor, frame_set: SynchronizedFrameSet, light: bool, half: bool) -> dict:
        """Front half of a tick: relocalization, IMU prediction, the step,
        and the start of its outputs' copies to the host. Returns the
        tick's record for :meth:`_finalize_values`."""
        tick = self._ticks_dispatched
        self._ticks_dispatched += 1
        with profiling.span("engine.dispatch", tick=tick):
            return self._dispatch(images, frame_set, light, half, tick)

    def _dispatch(self, images, frame_set: SynchronizedFrameSet, light: bool, half: bool, tick: int) -> dict:
        if self._want_reloc:
            # Rate-limited: each attempt is a synchronous find + verify.
            if self._reloc_countdown > 0:
                self._reloc_countdown -= 1
            else:
                # The attempt rewrites the live state: no in-flight record
                # may straddle it.
                while len(self._pending_q):
                    self._pending_q.finalize_ready()
                if persistence.attempt_relocalization(self, frame_set):
                    self._want_reloc = False
                    self._reloc_countdown = 0
                else:
                    self._reloc_countdown = self._reloc_interval - 1

        prediction = None
        if self._use_imu and frame_set.sensor_data is not None:
            gyro = frame_set.sensor_data.get("gyroscope")
            samples = len(gyro) if np.ndim(gyro) == 2 else int(gyro is not None)  # a batch, or one sample
            with profiling.span("engine.imu", samples=samples):
                self._imu.ingest(frame_set.sensor_data, frame_set.sensor_timestamp)
                prediction = self._imu.predict(frame_set.timestamp)
                profiling.annotate(accel=prediction is not None and self._imu.accel_pred_active())

        cam_active = None
        if frame_set.stale_sources:
            cam_active = self._host_tensor([name not in frame_set.stale_sources for name in self._source_order])
        self._light_ctl.note_dispatch(light)
        self._tracker_state, out = self._track(
            self._tracker_state, images, self._generator, cam_active=cam_active,
            pose_prediction=None if prediction is None else self._host_tensor(prediction),
            light=light, half=half,
        )
        # Only freshly packed tensors enter the record, never one that
        # aliases the state: BA writes into the state before this record
        # may be finalized. BA reads the observations of the ticks it
        # collects, loop closure the signature of keyframes.
        rec = {
            "packed": trk.pack_output(out),
            "ba_obs": trk.pack_ba_obs(out, self._tracker_state.lm_pos_w) if self._enable_ba else None,
            "kf_sig": (
                trk.pack_kf_sig(self._tracker_state)
                if self._config.enable_loop_closure and out.refreshed_host
                else None
            ),
            "event": None,
            "corr_epoch": self._ba_corr_total,
            "ts": frame_set.timestamp,
            "stale_sources": frame_set.stale_sources,
            "pred": prediction,
            "light": light,
            "half": half,
            "mono_bootstrap": None,
            "tick": tick,
        }
        self._start_fetch(rec)
        # After the tick's outputs are packed: they describe the step, not
        # the bootstrap that may follow it.
        if self._all_mono and not self._mono_boot_done:
            rec["mono_bootstrap"] = self._attempt_mono_bootstrap()
        return rec

    def _host_tensor(self, values) -> torch.Tensor:
        """A host tensor for the step, pinned when the step runs on a card:
        the step copies it to the device without waiting."""
        t = torch.as_tensor(values)
        return t.pin_memory() if self._device.type == "cuda" else t

    def _start_fetch(self, rec: dict) -> None:
        """Start the record's device-to-host copies into pinned memory and
        record one event behind them (the record's readiness). On the CPU
        the outputs are host tensors already."""
        if self._device.type != "cuda":
            return
        for key in self._FETCH_KEYS:
            value = rec[key]
            if value is not None:
                host = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
                host.copy_(value, non_blocking=True)
                rec[key] = host
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self._device))
        rec["event"] = event

    def _fetch_records(self, records: list[dict]) -> None:
        """Wait for each record's copies and replace its tensors by numpy
        arrays, in place."""
        for rec in records:
            with profiling.span("engine.fetch_wait", kind="wait", tick=rec["tick"]):
                if rec["event"] is not None:
                    rec["event"].synchronize()
                    rec["event"] = None
                for key in self._FETCH_KEYS:
                    if isinstance(rec[key], torch.Tensor):
                        rec[key] = rec[key].numpy()

    def _finalize_tick(self, rec: dict) -> SlamPose | None:
        """Back half of a synchronous tick: fetch, then finalize."""
        self._fetch_records([rec])
        return self._finalize_values(rec)

    def _attempt_mono_bootstrap(self) -> dict | None:
        """While an all-mono rig has no map: the two-view bootstrap against
        the live state (the tracks the tick just advanced against their
        keyframe anchors), every other tick after the first two. Returns
        the attempt's outcome, or None when no attempt was made."""
        if self._mono_boot_countdown > 0:
            self._mono_boot_countdown -= 1
            return None
        # The flag's readback closes the attempt; the host's clock around it
        # also holds whatever the device had queued before it.
        start = time.perf_counter()
        self._tracker_state, flag = trk.mono_init(
            self._params, self._setup, self._tracker_state, generator=self._generator
        )
        success, inliers, parallax, landmarks = flag.tolist()
        attempt = {
            "success": success > 0.5, "inliers": int(inliers), "parallax": parallax, "landmarks": int(landmarks),
            "ms": 1e3 * (time.perf_counter() - start),
        }
        if success > 0.5:
            self._mono_boot_done = True
            # The ticks in flight, plus two, may not re-arm it.
            self._mono_rearm_after = self._frame_count + self._pipeline_depth + 2
            logger.info(
                "mono bootstrap accepted: %d epipolar inliers, %d landmarks, mean parallax %.4f "
                "(up-to-scale gauge)", int(inliers), int(landmarks), parallax,
            )
        else:
            self._mono_boot_countdown = 1  # retry every other tick
        return attempt

    def _finalize_values(self, rec: dict) -> SlamPose | None:
        """Host state machine for one tick, given its fetched record."""
        # A lookup dispatched at an earlier keyframe resolves here.
        self._poll_loop()
        vals = trk.unpack_output(rec["packed"])
        world_t_body = vals["world_t_body"]
        num_inliers = vals["num_inliers"]
        refreshed = vals["refreshed"]
        covariance = vals["covariance"]
        ts = rec["ts"]
        min_inl = self._params.min_track_inliers

        # The residual before the epoch lift: the prediction and the solve
        # are both in the frame the device had at dispatch.
        pred_err = None
        if rec["pred"] is not None:
            pred_err = float(np.linalg.norm(np.asarray(rec["pred"], np.float64)[:3, 3] - world_t_body[:3, 3]))

        # Corrections the device had not seen when this tick was dispatched
        # (BA deltas written after it): lift the pose, its covariance and the
        # position channels shipped with it into the current odom frame.
        # Identity when every correction landed before the dispatch.
        epoch = rec["corr_epoch"]
        if epoch is not self._ba_corr_total:
            missing = self._ba_corr_total @ np.linalg.inv(epoch)
            world_t_body = missing @ world_t_body
            covariance = geometry.rotate_cov6(missing[:3, :3], covariance)
            # Channels: pack_ba_obs positions 7:10, pack_kf_sig 11:14.
            for key, sl in (("ba_obs", slice(7, 10)), ("kf_sig", slice(11, 14))):
                arr = rec[key]
                if arr is not None:
                    arr = np.array(arr)
                    arr[..., sl] = arr[..., sl] @ missing[:3, :3].T.astype(arr.dtype) + missing[:3, 3].astype(arr.dtype)
                    rec[key] = arr

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
            "stale_sources": sorted(rec["stale_sources"]),
            "light_tick": bool(rec["light"]),
            # The quality the tick shipped at (an adaptive degrade shows here).
            "light_half": bool(rec["half"]),
        }
        if pred_err is not None:
            diag["imu_pred_err_m"] = pred_err
        if self._use_imu and self._imu.estimate_gyro_bias:
            diag["gyro_bias_rad_s"] = float(np.linalg.norm(self._imu.gyro_bias))
        if self._use_accel:
            diag["accel_pred"] = self._imu.accel_pred_active()
            if self._imu.gravity_w is not None:
                diag["gravity_norm"] = float(np.linalg.norm(self._imu.gravity_w))
        if rec["mono_bootstrap"] is not None:  # this tick ended with a bootstrap attempt
            diag["mono_bootstrap"] = rec["mono_bootstrap"]
        self.last_diagnostics = diag

        self._imu.on_finalized(world_t_body, ts, tracked=num_inliers >= min_inl, epoch=self._ba_corr_total)
        self._last_timestamp = ts
        self._frame_count += 1

        # All-mono: a VO restart (blackout, long occlusion) empties the
        # landmark set; the bootstrap loop starts again. The guard keeps the
        # ticks dispatched before a fresh bootstrap from re-arming it.
        if (
            self._all_mono
            and self._mono_boot_done
            and vals["num_landmarks"] == 0
            and self._frame_count > self._mono_rearm_after
        ):
            self._mono_boot_done = False
            self._mono_boot_countdown = 1
            logger.info("mono bootstrap re-armed (landmark set emptied)")

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
                self._ba.push_tick(rec["ba_obs"], world_t_body, ts, refreshed)
            elif refreshed:
                # A refresh while untracked is a VO restart: fresh ids, the
                # old window cannot join.
                self._ba.clear()
            if refreshed and self._state_enum == TrackingState.TRACKING:
                # The correction lands on the newest live state; ticks
                # dispatched before it get the epoch lift at their finalize.
                with profiling.span("backend.ba", tick=rec["tick"]):
                    self._tracker_state, world_t_body, t_corr = self._ba.run(
                        world_t_body, covariance, self._tracker_state, self.last_diagnostics
                    )
                    profiling.annotate(skip=self.last_diagnostics.get("ba_skip"), **self._ba.last_solve)
                if t_corr is not None:
                    self._ba_corr_total = t_corr @ self._ba_corr_total
                    self._imu.on_correction(world_t_body, t_corr, self._ba_corr_total)
        if refreshed:
            self._last_kf_odom = world_t_body

        if refreshed and self._state_enum == TrackingState.TRACKING:
            map_pose = self._map_t_odom @ world_t_body
            self._keyframe_poses.append(SlamPose.from_4x4_matrix(map_pose, timestamp=ts))
            if self._config.enable_loop_closure and rec["kf_sig"] is not None:
                self._loop.on_keyframe(
                    map_pose, ts, trk.unpack_kf_sig(rec["kf_sig"]), self._map_t_odom, self._frame_count,
                    tick=rec["tick"],
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
        """Finalize every in-flight tick and return the last pose (None
        when synchronous: no tick is pending). Under ``defer_sync`` the
        whole stream is finalized here and :attr:`last_flush_poses` holds
        every tick's pose. Then a loop detection still in flight is
        drained (stream end)."""
        pose, per_tick = self._pending_q.drain()
        if per_tick is not None:
            self.last_flush_poses = per_tick
            return pose
        self._poll_loop(block=True)
        return pose

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
        """A fresh state; in-flight ticks are dropped and the uploader's
        thread is stopped (a new one starts with the next pipelined tick)."""
        if self._params is not None:
            self._tracker_state = self._fresh_state()
            self._generator = self._fresh_generator()
        self._clear_host_state()
        if self._state_enum != TrackingState.NOT_INITIALIZED:
            self._state_enum = TrackingState.INITIALIZING

    def shutdown(self) -> None:
        self._close_uploader()
        self._pending_q.clear()
        self._tracker_state = None
        self._state_enum = TrackingState.NOT_INITIALIZED
