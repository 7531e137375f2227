"""Core vocabulary of the camera layer.

API-compatible with the reference's ``thor_slam.camera.types``
(reference: thor_slam/camera/types.py:31-307) so downstream code — rigs,
engines, scripts — can swap between the two packages. Implementation is
original and fixes known reference quirks:

* ``IMUData`` is a real dataclass implementing :class:`SensorData`
  (the reference's version is annotation-only and never instantiable,
  reference types.py:113-128).
* ``Intrinsics`` gains ``scaled()`` / ``fx, fy, cx, cy`` accessors used by
  the TPU rectification path.
* ``Extrinsics`` gains ``compose()`` / ``inverse()``.

Copy of :mod:`thor_slam_tpu.camera.types`, kept in the port so that
the port imports nothing of the JAX package; keep the two in step.
"""

from __future__ import annotations

import ipaddress
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Literal, Self

import numpy as np

from thor_slam_tpu_torch import geometry

CameraSensorType = Literal["COLOR", "MONO"]


class IPv4(str):
    """A validated IPv4 address string."""

    def __new__(cls, ip: str) -> "IPv4":
        try:
            ipaddress.IPv4Address(ip)
        except (ipaddress.AddressValueError, ValueError) as e:
            raise ValueError(f"Invalid IPv4 address: {ip}") from e
        return super().__new__(cls, ip)

    @property
    def ip(self) -> str:
        """The address as a plain string (reference-API compatibility)."""
        return str(self)


@dataclass
class Intrinsics:
    """Pinhole camera intrinsics for one imager.

    Attributes:
        width: Image width in pixels.
        height: Image height in pixels.
        matrix: 3x3 camera matrix K = [[fx, 0, cx], [0, fy, cy], [0, 0, 1]].
        coeffs: Distortion coefficients (OpenCV plumb-bob / rational order).
    """

    width: int
    height: int
    matrix: np.ndarray
    coeffs: np.ndarray

    @property
    def fx(self) -> float:
        return float(self.matrix[0, 0])

    @property
    def fy(self) -> float:
        return float(self.matrix[1, 1])

    @property
    def cx(self) -> float:
        return float(self.matrix[0, 2])

    @property
    def cy(self) -> float:
        return float(self.matrix[1, 2])

    def scaled(self, new_width: int, new_height: int) -> Self:
        """Intrinsics rescaled for a different output resolution."""
        sx = new_width / self.width
        sy = new_height / self.height
        k = self.matrix.astype(np.float64).copy()
        k[0, :] *= sx
        k[1, :] *= sy
        return type(self)(width=new_width, height=new_height, matrix=k, coeffs=np.asarray(self.coeffs).copy())


@dataclass
class Extrinsics:
    """Rigid transform of a camera: rotation (3x3) + translation (3,), meters."""

    rotation: np.ndarray
    translation: np.ndarray

    @classmethod
    def identity(cls) -> Self:
        return cls(rotation=np.eye(3), translation=np.zeros(3))

    @classmethod
    def from_4x4_matrix(cls, matrix: np.ndarray | list[list[float]]) -> Self:
        """Build from a 4x4 homogeneous transformation matrix."""
        m = np.asarray(matrix, dtype=np.float64)
        if m.shape != (4, 4):
            raise ValueError(f"Expected 4x4 matrix, got shape {m.shape}")
        return cls(rotation=m[:3, :3].copy(), translation=m[:3, 3].copy())

    def to_4x4_matrix(self) -> np.ndarray:
        """As a 4x4 homogeneous transformation matrix."""
        return geometry.se3_matrix(self.rotation, self.translation)

    def compose(self, other: "Extrinsics") -> "Extrinsics":
        """self ∘ other, i.e. apply ``other`` first then ``self``."""
        return Extrinsics.from_4x4_matrix(self.to_4x4_matrix() @ other.to_4x4_matrix())

    def inverse(self) -> "Extrinsics":
        """Analytic rigid inverse (R^T, -R^T t)."""
        return Extrinsics.from_4x4_matrix(geometry.se3_inverse(self.to_4x4_matrix()))


@dataclass
class IMUExtrinsics:
    """IMU pose (extrinsics) together with the source it is attached to."""

    source_name: str
    extrinsics: Extrinsics

    def to_4x4_matrix(self) -> np.ndarray:
        """As a 4x4 homogeneous transformation matrix."""
        return self.extrinsics.to_4x4_matrix()


@dataclass
class CameraFrame:
    """One image from one imager, with acquisition metadata."""

    image: np.ndarray
    timestamp: float
    sequence_num: int
    camera_name: str


class SensorData(ABC):
    """Base class for auxiliary (non-image) sensor samples."""

    @abstractmethod
    def get_timestamp(self) -> float:
        """Timestamp of the sample in seconds."""

    @abstractmethod
    def get_sequence_num(self) -> int:
        """Monotonic sequence number of the sample."""

    @abstractmethod
    def get_data(self) -> dict:
        """Payload as a dict of named numpy arrays."""


@dataclass
class IMUData(SensorData):
    """A single IMU sample: accelerometer (m/s^2) + gyroscope (rad/s).

    Unlike the reference's annotation-only class (reference types.py:113-128,
    never instantiable), this is a concrete dataclass.
    """

    accelerometer: np.ndarray
    gyroscope: np.ndarray
    timestamp: float
    sequence_num: int = 0

    def get_timestamp(self) -> float:
        return self.timestamp

    def get_sequence_num(self) -> int:
        return self.sequence_num

    def get_data(self) -> dict:
        return {"accelerometer": self.accelerometer, "gyroscope": self.gyroscope}


class CameraSource(ABC):
    """Contract every camera produces frames through.

    Mirrors the reference ABC exactly (reference types.py:131-210): this is
    the seam that lets hardware sources, dataset replay, and synthetic
    sources interchange beneath :class:`~thor_slam_tpu_torch.camera.rig.CameraRig`.
    """

    @property
    @abstractmethod
    def name(self) -> str:
        """Unique name of this source (conventionally its IP or dataset id)."""

    @abstractmethod
    def start(self) -> None:
        """Begin producing frames."""

    @abstractmethod
    def stop(self) -> None:
        """Stop producing frames and release resources."""

    @abstractmethod
    def get_latest_frames(self) -> list[CameraFrame]:
        """Blocking fetch of the newest frame group (e.g. [left, right])."""

    @abstractmethod
    def try_get_latest_frames(self) -> list[CameraFrame] | None:
        """Non-blocking fetch; None when nothing new is available."""

    @abstractmethod
    def get_intrinsics(self) -> list[Intrinsics]:
        """Per-imager intrinsics, index-aligned with frame lists."""

    @abstractmethod
    def get_extrinsics(self) -> list[Extrinsics]:
        """Per-imager extrinsics in this source's reference frame."""

    @abstractmethod
    def get_sensor_extrinsics(self) -> Extrinsics | None:
        """Extrinsics of the auxiliary sensor (IMU) in this source's frame."""

    @abstractmethod
    def get_timestamped_sensor_data(self) -> tuple[dict | None, float | None]:
        """Blocking fetch of (sensor payload, timestamp), if any."""

    def try_get_timestamped_sensor_data(self) -> tuple[dict | None, float | None]:
        """Non-blocking best-effort fetch of (sensor payload, timestamp)."""
        if not self.has_sensor_data:
            return None, None
        try:
            return self.get_timestamped_sensor_data()
        except Exception:
            return None, None

    @property
    @abstractmethod
    def has_sensor_data(self) -> bool:
        """Whether this source produces auxiliary sensor (IMU) data."""


@dataclass
class FrameSet:
    """Frames captured together by one source ([left, right] for stereo)."""

    timestamp: float
    frames: list[CameraFrame]
    source_name: str
    sensor_data: dict | None = None
    sensor_timestamp: float | None = None

    @classmethod
    def from_frames(cls, frames: list[CameraFrame], source_name: str) -> Self:
        """Build from a non-empty frame list; reference ts = first frame's."""
        if not frames:
            raise ValueError("Cannot create FrameSet from empty frame list")
        return cls(timestamp=frames[0].timestamp, frames=list(frames), source_name=source_name)

    def get_timestamps(self) -> list[float]:
        return [f.timestamp for f in self.frames]

    def get_max_timestamp(self) -> float:
        return max(self.get_timestamps())

    def get_min_timestamp(self) -> float:
        return min(self.get_timestamps())

    def get_timestamp_spread(self) -> float:
        """Newest minus oldest frame timestamp within this set."""
        ts = self.get_timestamps()
        return max(ts) - min(ts)


@dataclass
class SynchronizedFrameSet:
    """Frame sets from every source, matched to one reference timestamp.

    ``stale_sources`` names sources the rig's watchdog marked as no longer
    producing frames (their entries in ``frame_sets``, when present, are the
    last data seen before the stall). Empty unless the rig was created with
    ``watchdog_timeout_s`` — the reference has no failure detection at all
    (SURVEY.md §5.3), so downstream code treating this as always-empty
    matches reference behavior.
    """

    timestamp: float
    frame_sets: dict[str, FrameSet]
    max_time_delta: float
    sensor_data: dict | None = None
    sensor_timestamp: float | None = None
    stale_sources: frozenset[str] = frozenset()

    def get_all_frames(self) -> list[CameraFrame]:
        """Every frame from every source, flattened."""
        out: list[CameraFrame] = []
        for fs in self.frame_sets.values():
            out.extend(fs.frames)
        return out

    def get_frames_for_source(self, source_name: str) -> list[CameraFrame] | None:
        fs = self.frame_sets.get(source_name)
        return fs.frames if fs is not None else None

    def get_all_timestamps(self) -> dict[str, list[float]]:
        """source_name -> per-frame timestamps."""
        return {name: fs.get_timestamps() for name, fs in self.frame_sets.items()}

    def get_timestamp_for_frame(self, source_name: str, frame_index: int) -> float | None:
        frames = self.get_frames_for_source(source_name)
        if frames is None or not (0 <= frame_index < len(frames)):
            return None
        return frames[frame_index].timestamp
