"""Luxonis OAK PoE camera driver (optional ``depthai`` dependency).

Clean-room counterpart of the reference's only hardware source (reference
thor_slam/camera/drivers/luxonis.py): builds the on-device DepthAI pipeline
(stereo CAM_B/CAM_C captures, optional IMU node), drains XLink output
queues, reads EEPROM calibration, and exposes everything through the
:class:`~thor_slam_tpu_torch.camera.types.CameraSource` contract.

Differences from the reference, by design:

* No on-camera StereoDepth/Sync nodes: dense depth is produced on the GPU
  (:mod:`thor_slam_tpu_torch.pipeline.rgbd`), so the camera ships raw stereo
  frames only — less PoE bandwidth, no ASIC dependence.
* Calibration conventions preserved exactly: DepthAI extrinsic translations
  are centimeters -> converted to meters at every read (reference
  luxonis.py:694-703), intrinsics rescaled from sensor to output resolution
  (reference luxonis.py:596-673), OAK-D Pro IMU frame is DRB (handled by
  the apps, reference run_slam.py:254-276).

Pure helpers (resolution scaling, cm->m) are module-level and unit-tested
without hardware; everything touching ``depthai`` is gated.

Copy of :mod:`thor_slam_tpu.camera.sources.luxonis`, kept in the port so
that the port imports nothing of the JAX package; keep the two in step.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import TypedDict

import numpy as np

from thor_slam_tpu_torch.camera.types import (
    CameraFrame,
    CameraSensorType,
    CameraSource,
    Extrinsics,
    Intrinsics,
    IPv4,
)

logger = logging.getLogger(__name__)

try:  # pragma: no cover - hardware SDK
    import depthai as dai

    HAVE_DEPTHAI = True
except ImportError:
    dai = None
    HAVE_DEPTHAI = False


#: Output resolutions the OAK sensors support, by short name
#: (reference luxonis.py:38-46).
SUPPORTED_RESOLUTIONS: dict[str, tuple[int, int]] = {
    "400": (640, 400),
    "480": (640, 480),
    "720": (1280, 720),
    "800": (1280, 800),
    "1200": (1920, 1200),
}


class IMUData(TypedDict):
    """One IMU packet: body-frame accel (m/s^2) + gyro (rad/s)."""

    accelerometer: np.ndarray
    gyroscope: np.ndarray
    timestamp: float
    sequence_num: int


@dataclass
class LuxonisResolution:
    """A validated (width, height) pair from the supported table."""

    width: int
    height: int

    @classmethod
    def from_tuple(cls, wh: tuple[int, int]) -> "LuxonisResolution":
        if tuple(wh) not in SUPPORTED_RESOLUTIONS.values():
            raise ValueError(
                f"Unsupported resolution {wh}; supported: {sorted(SUPPORTED_RESOLUTIONS.values())}"
            )
        return cls(width=wh[0], height=wh[1])


@dataclass
class LuxonisRGBDCameraConfig:
    """RGB capture options when a camera also feeds the RGB-D product.

    This build computes depth off-camera, so only the RGB leg of the
    reference's RGB-D config survives (reference luxonis.py:92-115).

    Attributes:
        rgb_sensor_resolution: Explicit color sensor mode, or None to
            auto-select one against the output/mono resolutions
            (:func:`select_rgb_sensor_resolution`, the reference's scoring
            luxonis.py:276-312).
        rgb_output_resolution: Resolution of the published color stream —
            independent of the SLAM stream (the reference's
            resolution-independence contract, reference
            run_pipeline.py:138-148). None = the (auto-)selected sensor
            resolution.
        align_depth_to_rgb: Produce depth in the COLOR camera's frame
            (the GPU depth aligner; reference aligns on the ASIC,
            luxonis.py:538-549).
    """

    rgb_sensor_resolution: tuple[int, int] | None = None
    rgb_output_resolution: tuple[int, int] | None = None
    align_depth_to_rgb: bool = True


def select_rgb_sensor_resolution(
    valid_resolutions: list[tuple[int, int]],
    rgb_output_resolution: tuple[int, int] | None,
    mono_resolution: tuple[int, int],
) -> tuple[int, int]:
    """Pick the color sensor mode for the RGB-D leg.

    Scoring semantics preserved from the reference (luxonis.py:276-312):

    * with a requested output resolution, prefer the SMALLEST sensor mode
      that still covers it (no upscaling); sensor modes too small for the
      output are heavily penalized (used only as a last resort);
    * with no requested output, prefer the mode closest to the SLAM mono
      resolution in pixel count, tie-broken by aspect-ratio similarity.

    Args:
        valid_resolutions: Sensor modes the color imager supports.
        rgb_output_resolution: Desired output, or None.
        mono_resolution: The SLAM stereo sensor resolution.

    Returns:
        The chosen (width, height).

    Raises:
        ValueError: If ``valid_resolutions`` is empty.
    """
    if not valid_resolutions:
        raise ValueError("color imager reports no supported resolutions")
    best, best_score = None, float("inf")
    for res in valid_resolutions:
        if rgb_output_resolution is not None:
            if res[0] >= rgb_output_resolution[0] and res[1] >= rgb_output_resolution[1]:
                score = float(res[0] * res[1])  # smallest covering mode
            else:
                score = 1_000_000.0 + (
                    rgb_output_resolution[0] * rgb_output_resolution[1] - res[0] * res[1]
                )
        else:
            pixel_diff = abs(res[0] * res[1] - mono_resolution[0] * mono_resolution[1])
            aspect_diff = abs(res[0] / res[1] - mono_resolution[0] / mono_resolution[1])
            score = pixel_diff + aspect_diff * 10_000.0
        if score < best_score:
            best, best_score = res, score
    assert best is not None
    return tuple(best)


def validate_camera_config(
    config: "LuxonisCameraConfig",
    valid_resolutions: dict[str, list[tuple[int, int]]],
    valid_modes: dict[str, list[str]],
) -> list[ValueError]:
    """Validate a camera configuration against the device's capabilities.

    Pure logic (unit-testable without hardware): the driver's constructor
    feeds it the per-socket capability tables queried from the device and
    raises the collected errors as one ``ExceptionGroup`` — the
    reference's validation pattern (luxonis.py:193-253).

    Args:
        config: The bring-up configuration.
        valid_resolutions: socket name ("CAM_A"/"CAM_B"/"CAM_C") ->
            supported sensor resolutions.
        valid_modes: socket name -> supported sensor types ("MONO"/"COLOR").

    Returns:
        All configuration errors found (empty when valid).
    """
    errors: list[ValueError] = []
    res = tuple(config.resolution)
    sockets = ("CAM_B", "CAM_C") if config.stereo else ("CAM_A",)

    res_ok = any(res in [tuple(r) for r in valid_resolutions.get(s, [])] for s in sockets)
    mode_ok = any(config.sensor_type in valid_modes.get(s, []) for s in sockets)
    if not res_ok:
        supported = sorted(
            {tuple(r) for s in sockets for r in valid_resolutions.get(s, [])}
        )
        errors.append(
            ValueError(
                f"Sensor resolution {res} not supported on {'/'.join(sockets)}; "
                f"supported: {supported}"
            )
        )
    if not mode_ok:
        supported_modes = sorted(
            {m for s in sockets for m in valid_modes.get(s, [])}
        )
        errors.append(
            ValueError(
                f"Sensor type {config.sensor_type!r} not supported on "
                f"{'/'.join(sockets)}; supported: {supported_modes}"
            )
        )

    if config.rgbd is not None:
        if not config.stereo:
            errors.append(ValueError("RGB-D requires stereo=True (depth needs CAM_B/C)"))
        if "COLOR" not in valid_modes.get("CAM_A", []):
            errors.append(
                ValueError(
                    "RGB-D requires a COLOR imager on CAM_A; supported modes: "
                    f"{valid_modes.get('CAM_A', [])}"
                )
            )
        rgb_sensor = config.rgbd.rgb_sensor_resolution
        if rgb_sensor is not None:
            cam_a = [tuple(r) for r in valid_resolutions.get("CAM_A", [])]
            if tuple(rgb_sensor) not in cam_a:
                errors.append(
                    ValueError(
                        f"RGB sensor resolution {tuple(rgb_sensor)} not supported "
                        f"on CAM_A; supported: {sorted(cam_a)}"
                    )
                )
        out = config.rgbd.rgb_output_resolution
        if out is not None and rgb_sensor is not None and (
            out[0] > rgb_sensor[0] or out[1] > rgb_sensor[1]
        ):
            errors.append(
                ValueError(
                    f"rgb_output_resolution {tuple(out)} exceeds the sensor "
                    f"resolution {tuple(rgb_sensor)} (upscaling is never useful)"
                )
            )
    return errors


@dataclass
class LuxonisCameraConfig:
    """Bring-up options for one OAK PoE camera (reference luxonis.py:118-141)."""

    ip: IPv4
    fps: float = 30.0
    stereo: bool = True
    sensor_type: CameraSensorType = "MONO"
    resolution: tuple[int, int] = (640, 400)
    output_resolution: tuple[int, int] | None = None
    queue_size: int = 8
    queue_blocking: bool = False
    read_imu: bool = False
    imu_report_rate: int = 400
    imu_batch_report_threshold: int = 5
    rgbd: LuxonisRGBDCameraConfig | None = None


def scale_intrinsics_to_output(
    matrix: np.ndarray,
    sensor_wh: tuple[int, int],
    output_wh: tuple[int, int],
) -> np.ndarray:
    """Rescale a camera matrix from sensor to output resolution.

    Mirrors the reference's sensor->output scaling (luxonis.py:596-673):
    plain axis scaling (DepthAI outputs are scaled, not letterboxed, when
    aspect ratios match — mixed aspect ratios use the full-width scale).
    """
    sx = output_wh[0] / sensor_wh[0]
    sy = output_wh[1] / sensor_wh[1]
    k = np.asarray(matrix, np.float64).copy()
    k[0, :] *= sx
    k[1, :] *= sy
    return k


def extrinsics_cm_to_m(matrix_cm: np.ndarray) -> np.ndarray:
    """DepthAI EEPROM extrinsics carry centimeter translations; convert
    the translation column to meters (reference luxonis.py:694-703)."""
    m = np.asarray(matrix_cm, np.float64).copy()
    m[:3, 3] *= 0.01
    return m


class LuxonisCameraSource(CameraSource):  # pragma: no cover - hardware
    """A stereo/mono OAK PoE camera as a :class:`CameraSource`."""

    def __init__(self, config: LuxonisCameraConfig) -> None:
        if not HAVE_DEPTHAI:
            raise ImportError(
                "depthai is not installed; install 'thor-slam-tpu[hardware]' "
                "or use the synthetic/dataset sources"
            )
        self._config = config
        LuxonisResolution.from_tuple(config.resolution)
        self._device = None
        self._pipeline = None
        self._queues: dict[str, object] = {}
        self._running = False
        self._imu_packets: list[IMUData] = []
        self._seq = 0
        self._rgb_sensor_resolution: tuple[int, int] | None = None

        from thor_slam_tpu_torch.camera.utils import (
            get_luxonis_camera_valid_modes,
            get_luxonis_camera_valid_resolutions,
            get_luxonis_device,
        )

        self._device = get_luxonis_device(config.ip)
        if self._device is None:
            raise RuntimeError(f"No DepthAI device at {config.ip}")

        # Capability tables by socket, then pure-logic validation — errors
        # are collected and raised together (the reference's ExceptionGroup
        # pattern, reference luxonis.py:193-253).
        socket_of = {
            "CAM_A": dai.CameraBoardSocket.CAM_A,
            "CAM_B": dai.CameraBoardSocket.CAM_B,
            "CAM_C": dai.CameraBoardSocket.CAM_C,
        }
        valid_res, valid_modes = {}, {}
        for name, socket in socket_of.items():
            try:
                valid_res[name] = get_luxonis_camera_valid_resolutions(self._device, socket)
                valid_modes[name] = get_luxonis_camera_valid_modes(self._device, socket)
            except Exception:  # socket absent on this model
                valid_res[name], valid_modes[name] = [], []
        errors = validate_camera_config(config, valid_res, valid_modes)
        if errors:
            raise ExceptionGroup(
                f"Invalid camera configuration for {config.ip}", errors
            ) from errors[0]

        if config.rgbd is not None:
            self._rgb_sensor_resolution = (
                tuple(config.rgbd.rgb_sensor_resolution)
                if config.rgbd.rgb_sensor_resolution is not None
                else select_rgb_sensor_resolution(
                    valid_res.get("CAM_A", []),
                    config.rgbd.rgb_output_resolution,
                    config.resolution,
                )
            )
            logger.info(
                "RGB sensor resolution for %s: %s (output %s)",
                config.ip, self._rgb_sensor_resolution,
                config.rgbd.rgb_output_resolution or self._rgb_sensor_resolution,
            )

        self._calib = self._device.readCalibration()

    # -- pipeline -----------------------------------------------------------

    def _build_and_start_pipeline(self) -> None:
        """DepthAI v3 pipeline graph: Camera nodes with requested outputs.

        The node graph the reference builds (reference luxonis.py:364-594),
        minus its StereoDepth/Sync legs — depth is produced and aligned on
        the GPU (pipeline/rgbd.py). Each imager is a `dai.node.Camera`
        built at its SENSOR resolution; the published streams are
        `requestOutput`s at the configured OUTPUT resolutions (letterboxed
        when the aspect ratio changes), so the SLAM and color streams stay
        resolution-independent.
        """
        cfg = self._config
        pipeline = dai.Pipeline(self._device)
        fps = float(cfg.fps)
        sensor_type = {
            "MONO": dai.CameraSensorType.MONO,
            "COLOR": dai.CameraSensorType.COLOR,
        }[cfg.sensor_type]
        out_res = tuple(cfg.output_resolution or cfg.resolution)

        def build_cam(socket, stype, sensor_res):
            cam = pipeline.create(dai.node.Camera)
            cam.setSensorType(stype)
            cam.build(boardSocket=socket, sensorResolution=tuple(sensor_res), sensorFps=fps)
            return cam

        def request(cam, sensor_res, size):
            if tuple(size) == tuple(sensor_res):
                return cam.requestFullResolutionOutput()
            return cam.requestOutput(
                size=tuple(size), resizeMode=dai.ImgResizeMode.LETTERBOX, fps=fps
            )

        def queue_of(output):
            return output.createOutputQueue(
                maxSize=cfg.queue_size, blocking=cfg.queue_blocking
            )

        if cfg.stereo:
            for name, socket in (("left", dai.CameraBoardSocket.CAM_B),
                                 ("right", dai.CameraBoardSocket.CAM_C)):
                cam = build_cam(socket, sensor_type, cfg.resolution)
                self._queues[name] = queue_of(request(cam, cfg.resolution, out_res))

            # RGB-D color leg: a CAM_A color capture at its own (sensor,
            # output) resolutions — fully independent of the SLAM stream
            # (reference luxonis.py:464-511; resolution independence
            # reference run_pipeline.py:138-148).
            if cfg.rgbd is not None:
                rgb_cam = build_cam(
                    dai.CameraBoardSocket.CAM_A,
                    dai.CameraSensorType.COLOR,
                    self._rgb_sensor_resolution,
                )
                rgb_out_res = cfg.rgbd.rgb_output_resolution or self._rgb_sensor_resolution
                self._queues["rgb"] = queue_of(
                    request(rgb_cam, self._rgb_sensor_resolution, rgb_out_res)
                )
        else:
            cam = build_cam(dai.CameraBoardSocket.CAM_A, sensor_type, cfg.resolution)
            self._queues["rgb"] = queue_of(request(cam, cfg.resolution, out_res))

        if cfg.read_imu:
            imu = pipeline.create(dai.node.IMU)
            imu.enableIMUSensor(
                [dai.IMUSensor.ACCELEROMETER_RAW, dai.IMUSensor.GYROSCOPE_RAW],
                cfg.imu_report_rate,
            )
            imu.setBatchReportThreshold(cfg.imu_batch_report_threshold)
            imu.setMaxBatchReports(20)
            self._queues["imu"] = queue_of(imu.out)

        pipeline.start()
        self._pipeline = pipeline

    # -- CameraSource contract ----------------------------------------------

    @property
    def name(self) -> str:
        return str(self._config.ip)

    def start(self) -> None:
        if self._running:
            return
        self._build_and_start_pipeline()
        self._running = True

    def stop(self) -> None:
        if not self._running:
            return
        self._running = False
        if self._pipeline is not None:  # v3: the pipeline owns the session
            self._pipeline.stop()
            self._pipeline = None
        self._queues.clear()

    def _to_frame(self, msg, cam_name: str) -> CameraFrame:
        # Device timestamps synced to the host time base (DepthAI
        # getTimestamp(), not wall clock): capture-time accuracy, and one
        # COMMON clock with the per-packet IMU timestamps so preintegration
        # windows line up. The reference stamps frames with host time.time()
        # at dequeue but IMU with device timestamps (reference
        # luxonis.py:790-791 vs 1117-1118) — a mixed-clock pairing this
        # rebuild deliberately does not reproduce.
        return CameraFrame(
            image=msg.getCvFrame(),
            timestamp=msg.getTimestamp().total_seconds(),
            sequence_num=msg.getSequenceNum(),
            camera_name=cam_name,
        )

    def get_latest_frames(self) -> list[CameraFrame]:
        if not self._running:
            raise RuntimeError("start() first")
        if self._config.stereo:
            left = self._queues["left"].get()
            right = self._queues["right"].get()
            return [
                self._to_frame(left, f"{self.name}_left"),
                self._to_frame(right, f"{self.name}_right"),
            ]
        msg = self._queues["rgb"].get()
        return [self._to_frame(msg, f"{self.name}_rgb")]

    def try_get_latest_frames(self) -> list[CameraFrame] | None:
        if not self._running:
            return None
        if self._config.stereo:
            left = self._queues["left"].tryGet()
            right = self._queues["right"].tryGet()
            if left is None or right is None:
                return None
            return [
                self._to_frame(left, f"{self.name}_left"),
                self._to_frame(right, f"{self.name}_right"),
            ]
        msg = self._queues["rgb"].tryGet()
        return [self._to_frame(msg, f"{self.name}_rgb")] if msg is not None else None

    def get_intrinsics(self) -> list[Intrinsics]:
        cfg = self._config
        out_w, out_h = cfg.output_resolution or cfg.resolution
        sockets = (
            [dai.CameraBoardSocket.CAM_B, dai.CameraBoardSocket.CAM_C]
            if cfg.stereo
            else [dai.CameraBoardSocket.CAM_A]
        )
        result = []
        for socket in sockets:
            k = np.asarray(self._calib.getCameraIntrinsics(socket, cfg.resolution[0], cfg.resolution[1]))
            k = scale_intrinsics_to_output(k, cfg.resolution, (out_w, out_h))
            coeffs = np.asarray(self._calib.getDistortionCoefficients(socket), np.float64)
            result.append(Intrinsics(width=out_w, height=out_h, matrix=k, coeffs=coeffs))
        return result

    def get_extrinsics(self) -> list[Extrinsics]:
        cfg = self._config
        if not cfg.stereo:
            return [Extrinsics.identity()]
        # Left is the source reference; right = left_T_right from EEPROM.
        l_to_r = np.asarray(
            self._calib.getCameraExtrinsics(dai.CameraBoardSocket.CAM_B, dai.CameraBoardSocket.CAM_C)
        )
        left_t_right = np.linalg.inv(extrinsics_cm_to_m(l_to_r))
        return [Extrinsics.identity(), Extrinsics.from_4x4_matrix(left_t_right)]

    # -- RGB-D color leg -----------------------------------------------------

    def try_get_latest_rgb_frame(self) -> CameraFrame | None:
        """Newest color frame from the RGB-D leg (non-blocking), or None.

        The RGB-D product stream drains this independently of the SLAM
        frames (reference run_pipeline.py:624-631 semantics).
        """
        if not self._running or "rgb" not in self._queues:
            return None
        msg = self._queues["rgb"].tryGet()
        if msg is None:
            return None
        return self._to_frame(msg, f"{self.name}_rgb")

    def get_rgb_intrinsics(self) -> Intrinsics | None:
        """CAM_A color intrinsics at the RGB output resolution."""
        cfg = self._config
        if cfg.rgbd is None or self._rgb_sensor_resolution is None:
            return None
        out_wh = cfg.rgbd.rgb_output_resolution or self._rgb_sensor_resolution
        k = np.asarray(
            self._calib.getCameraIntrinsics(
                dai.CameraBoardSocket.CAM_A,
                self._rgb_sensor_resolution[0],
                self._rgb_sensor_resolution[1],
            )
        )
        k = scale_intrinsics_to_output(k, self._rgb_sensor_resolution, out_wh)
        coeffs = np.asarray(
            self._calib.getDistortionCoefficients(dai.CameraBoardSocket.CAM_A), np.float64
        )
        return Intrinsics(width=out_wh[0], height=out_wh[1], matrix=k, coeffs=coeffs)

    def get_rgb_extrinsics(self) -> Extrinsics | None:
        """Pose of the color imager in the source (left-camera) frame.

        ``left_T_color`` with the EEPROM's centimeter translations
        converted to meters — what the GPU depth->color aligner consumes
        (the reference aligns on the ASIC instead, luxonis.py:538-549).
        """
        if self._config.rgbd is None:
            return None
        b_to_a = np.asarray(
            self._calib.getCameraExtrinsics(
                dai.CameraBoardSocket.CAM_B, dai.CameraBoardSocket.CAM_A
            )
        )
        left_t_color = np.linalg.inv(extrinsics_cm_to_m(b_to_a))
        return Extrinsics.from_4x4_matrix(left_t_color)

    def get_sensor_extrinsics(self) -> Extrinsics | None:
        if not self._config.read_imu:
            return None
        try:
            m = np.asarray(self._calib.getImuToCameraExtrinsics(dai.CameraBoardSocket.CAM_A))
            return Extrinsics.from_4x4_matrix(extrinsics_cm_to_m(m))
        except Exception:
            logger.warning("IMU extrinsics unavailable; using identity")
            return Extrinsics.identity()

    def get_timestamped_sensor_data(self) -> tuple[dict | None, float | None]:
        if not self._config.read_imu or "imu" not in self._queues:
            return None, None
        msg = self._queues["imu"].tryGet()
        if msg is None:
            return None, None
        accels, gyros, times = [], [], []
        for pkt in msg.packets:
            a = pkt.acceleroMeter
            g = pkt.gyroscope
            accels.append([a.x, a.y, a.z])
            gyros.append([g.x, g.y, g.z])
            # PER-PACKET device timestamps (reference luxonis.py:1117-1118).
            # Stamping the whole batch with host time.time() collapses a
            # 5-sample packet onto near-identical timestamps; the engine's
            # strictly-increasing filter then keeps ~1 of 5 samples and the
            # preintegration dts are garbage.
            times.append(a.getTimestamp().total_seconds())
        if not accels:
            return None, None
        self._seq += 1
        data: IMUData = {
            "accelerometer": np.asarray(accels),
            "gyroscope": np.asarray(gyros),
            "timestamp": times[-1],
            "sequence_num": self._seq,
        }
        data["timestamps"] = np.asarray(times)  # type: ignore[typeddict-unknown-key]
        return dict(data), times[-1]

    @property
    def has_sensor_data(self) -> bool:
        return self._config.read_imu
