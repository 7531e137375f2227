"""The calibration of an ASL/EuRoC sequence, its IMU included.

EuRoC describes its sensor head in three ``sensor.yaml`` files
(``mav0/cam0``, ``mav0/cam1``, ``mav0/imu0``): each sensor's pose in the
body frame (``T_BS``), and for the cameras ``resolution``, ``intrinsics``
(fu, fv, cu, cv) and radial-tangential ``distortion_coefficients``. The
body frame is the IMU's (imu0's ``T_BS`` is the identity), which sits
6.9 cm from cam0 with its axes turned about 90 degrees from cam0's.

:class:`EurocCameraSource` (a copy of the reference's) declares the IMU at
cam0 with cam0's axes; :class:`EurocSensorSource` is that source with the
calibration of :func:`read_calibration`, and :func:`imu_extrinsics` gives
the IMU's pose in cam0 for ``CameraRig``, as ``scripts/run_euroc.py``
builds it. The files are read without pyyaml: :func:`parse_sensor_yaml`
reads the flat subset EuRoC's files use.

Precedence of :func:`read_calibration`: an explicit override;
``mav0/calibration.npz`` (written by ``scripts/make_euroc_synthetic``; its
IMU is the identity unless it carries ``c0_t_imu``); the three
``sensor.yaml`` files; the VI-sensor's published values.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from thor_slam_tpu_torch.camera.sources.dataset import EurocCameraSource
from thor_slam_tpu_torch.camera.types import Extrinsics, IMUExtrinsics, Intrinsics

#: cam0's and cam1's pose in the VI-sensor's body (IMU) frame, from the
#: dataset's ``mav0/cam{0,1}/sensor.yaml``.
T_BS_CAM0 = np.array(
    [
        [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
        [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
        [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
        [0.0, 0.0, 0.0, 1.0],
    ]
)
T_BS_CAM1 = np.array(
    [
        [0.0125552670891, -0.999755099723, 0.0182237714554, -0.0198435579556],
        [0.999598781151, 0.0130119051815, 0.0251588363115, 0.0453689425024],
        [-0.0253898008918, 0.0179005838253, 0.999517347078, 0.00786212447038],
        [0.0, 0.0, 0.0, 1.0],
    ]
)


@dataclass(frozen=True)
class EurocCalibration:
    """The stereo pair and the IMU of a sequence, all in cam0's frame.

    ``intrinsics``: [cam0, cam1] (None: the source's published values at
    the size of the sequence's images); ``cam0_t_cam1`` and ``cam0_t_imu``:
    (4, 4) poses in cam0; ``origin``: where they were read.
    """

    intrinsics: list[Intrinsics] | None
    cam0_t_cam1: np.ndarray
    cam0_t_imu: np.ndarray
    origin: str


_NUMBER = re.compile(r"^[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?$")


def _value(text: str):
    text = text.strip()
    if text.startswith("["):
        return [_value(v) for v in text.strip("[]").split(",") if v.strip()]
    if _NUMBER.match(text):
        return float(text) if any(c in text for c in ".eE") else int(text)
    return text.strip("'\"")


def parse_sensor_yaml(text: str) -> dict:
    """The keys of an ASL ``sensor.yaml``: top-level ``key: value`` pairs,
    flow lists (``[a, b, ...]``, over several lines too) and one level of
    indented mapping (``T_BS``'s ``rows``, ``cols``, ``data``); comments
    dropped. Numbers come back as int or float, lists as lists."""
    out: dict = {}
    block: dict | None = None
    pending: tuple[dict, str, str] | None = None  # a flow list still open: (into, key, text so far)
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if pending is not None:
            into, key, so_far = pending
            so_far += " " + line.strip()
            if "]" in line:
                into[key], pending = _value(so_far), None
            else:
                pending = (into, key, so_far)
            continue
        if not line.strip() or ":" not in line:
            continue
        key, rest = (s.strip() for s in line.split(":", 1))
        indented = line[0] in " \t"
        into = block if indented and block is not None else out
        if not indented:
            block = None
        if not rest:
            block = into[key] = {}
        elif rest.startswith("[") and "]" not in rest:
            pending = (into, key, rest)
        else:
            into[key] = _value(rest)
    return out


def read_sensor_yaml(path: str | Path) -> dict:
    """:func:`parse_sensor_yaml` of a file, with ``T_BS`` as a (rows, cols) array."""
    out = parse_sensor_yaml(Path(path).read_text())
    if isinstance(out.get("T_BS"), dict):
        t = out["T_BS"]
        out["T_BS"] = np.asarray(t["data"], np.float64).reshape(int(t["rows"]), int(t["cols"]))
    return out


def _camera(yaml: dict) -> Intrinsics:
    fu, fv, cu, cv = (float(v) for v in yaml["intrinsics"])
    coeffs = np.zeros(5)
    d = np.asarray(yaml.get("distortion_coefficients", []), np.float64)
    coeffs[: len(d)] = d  # k1, k2, p1, p2 (k3 = 0)
    w, h = (int(v) for v in yaml["resolution"])
    return Intrinsics(width=w, height=h, matrix=np.array([[fu, 0.0, cu], [0.0, fv, cv], [0.0, 0.0, 1.0]]),
                      coeffs=coeffs)


def read_calibration(root: str | Path, override: EurocCalibration | None = None) -> EurocCalibration:
    """The calibration of the sequence at ``root`` (holding ``mav0/``), by
    the module's precedence."""
    if override is not None:
        return override
    mav = Path(root) / "mav0"
    npz = mav / "calibration.npz"
    if npz.exists():
        z = np.load(npz)
        w, h = int(z["width"]), int(z["height"])
        intr = [Intrinsics(width=w, height=h, matrix=z["k0"], coeffs=z["d0"]),
                Intrinsics(width=w, height=h, matrix=z["k1"], coeffs=z["d1"])]
        c0_t_imu = np.asarray(z["c0_t_imu"], np.float64) if "c0_t_imu" in z.files else np.eye(4)
        return EurocCalibration(intr, np.asarray(z["c0_t_c1"], np.float64), c0_t_imu, "calibration.npz")
    cams = [mav / cam / "sensor.yaml" for cam in ("cam0", "cam1")]
    if all(p.exists() for p in cams):
        y0, y1 = (read_sensor_yaml(p) for p in cams)
        imu_yaml = mav / "imu0" / "sensor.yaml"
        t_bs_imu = read_sensor_yaml(imu_yaml)["T_BS"] if imu_yaml.exists() else np.eye(4)
        c0_inv = np.linalg.inv(y0["T_BS"])
        return EurocCalibration([_camera(y0), _camera(y1)], c0_inv @ y1["T_BS"], c0_inv @ t_bs_imu, "sensor.yaml")
    c0_inv = np.linalg.inv(T_BS_CAM0)
    return EurocCalibration(None, c0_inv @ T_BS_CAM1, c0_inv, "vi-sensor")


class EurocSensorSource(EurocCameraSource):
    """:class:`EurocCameraSource` with the calibration of
    :func:`read_calibration` (``calibration``): the eyes' intrinsics,
    cam1's pose in cam0, and the IMU's pose in cam0 (``cam0_t_imu``,
    :meth:`get_sensor_extrinsics`)."""

    def __init__(
        self,
        root: str | Path,
        name: str | None = None,
        read_imu: bool = True,
        max_frames: int | None = None,
        calibration: EurocCalibration | None = None,
    ) -> None:
        calib = read_calibration(root, calibration)
        # Without intrinsics (no file describes the eyes) the source keeps
        # the published values at the size of the sequence's images.
        super().__init__(root, name=name, read_imu=read_imu, intrinsics=calib.intrinsics, max_frames=max_frames)
        self._ext = [Extrinsics.identity(), Extrinsics.from_4x4_matrix(calib.cam0_t_cam1)]
        self.calibration = calib
        self.cam0_t_imu = np.asarray(calib.cam0_t_imu, np.float64)

    def get_sensor_extrinsics(self) -> Extrinsics | None:
        return Extrinsics.from_4x4_matrix(self.cam0_t_imu) if self._imu else None


def imu_extrinsics(source: EurocSensorSource) -> IMUExtrinsics:
    """The IMU's pose in the rig frame (cam0's: the rig holds this one
    source at the identity), for ``CameraRig(imu_extrinsics=...)``."""
    return IMUExtrinsics(source_name=source.name, extrinsics=Extrinsics.from_4x4_matrix(source.cam0_t_imu))


def sensor_yaml(t_bs: np.ndarray, rate_hz: float, intrinsics: Intrinsics | None = None, comment: str = "") -> str:
    """The text of an ASL ``sensor.yaml`` in EuRoC's layout: ``T_BS`` and
    ``rate_hz``, and for a camera (``intrinsics`` given) ``resolution``,
    ``intrinsics`` and four radial-tangential coefficients."""
    rows = ",\n         ".join(", ".join(repr(float(v)) for v in row) for row in np.asarray(t_bs, np.float64))
    lines = [
        "# General sensor definitions.",
        f"sensor_type: {'imu' if intrinsics is None else 'camera'}",
        f"comment: {comment}",
        "",
        "# Sensor extrinsics wrt. the body-frame.",
        "T_BS:",
        "  cols: 4",
        "  rows: 4",
        f"  data: [{rows}]",
        "",
        f"rate_hz: {rate_hz:g}",
    ]
    if intrinsics is not None:
        k, d = np.asarray(intrinsics.matrix, np.float64), np.asarray(intrinsics.coeffs, np.float64)
        lines += [
            f"resolution: [{intrinsics.width}, {intrinsics.height}]",
            "camera_model: pinhole",
            "intrinsics: [" + ", ".join(repr(float(v)) for v in (k[0, 0], k[1, 1], k[0, 2], k[1, 2]))
            + "] #fu, fv, cu, cv",
            "distortion_model: radial-tangential",
            "distortion_coefficients: [" + ", ".join(repr(float(v)) for v in d[:4]) + "]",
        ]
    return "\n".join(lines) + "\n"
