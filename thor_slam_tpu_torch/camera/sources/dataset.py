"""Dataset-replay camera sources: EuRoC-layout and recorded directories.

The reference has no replay path at all — its only source is live hardware
(SURVEY.md §4 flags this as the missing seam). These sources let the full
stack run against standard benchmark datasets:

* :class:`EurocCameraSource` — the ASL/EuRoC MAV layout
  (``mav0/cam0/data/*.png`` + ``data.csv`` timestamps, ``mav0/imu0/data.csv``),
  the dataset family the accuracy target is defined on (BASELINE.md).
* :class:`RecordedCameraSource` — a simple directory-of-npz recording
  (one file per frame group) written by :func:`record_frames`, for
  replaying captures from real rigs.

Both emit frames at dataset timestamps (no wall-clock pacing — the rig's
synchronizer only cares about timestamp ordering).

Copy of :mod:`thor_slam_tpu.camera.sources.dataset`, kept in the port so
that the port imports nothing of the JAX package; keep the two in step
(the recordings of either package replay in the other).
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from thor_slam_tpu_torch.camera.types import CameraFrame, CameraSource, Extrinsics, Intrinsics


def _load_image(path: Path) -> np.ndarray:
    """Read a grayscale image (PNG via cv2 if present, else npy)."""
    if path.suffix == ".npy":
        return np.load(path)
    try:
        import cv2

        img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(path)
        return img
    except ImportError as e:  # pragma: no cover
        raise ImportError("cv2 required to read image datasets") from e


class EurocCameraSource(CameraSource):
    """Stereo replay of one EuRoC MAV sequence directory.

    Args:
        root: Sequence root containing ``mav0/``.
        name: Source name (defaults to the directory name).
        read_imu: Also stream ``mav0/imu0/data.csv``.
        intrinsics: Optional [left, right] override; defaults to the
            standard EuRoC VI-sensor calibration.
        max_frames: Optional cap for quick runs.
    """

    # Standard EuRoC VI-sensor calibration (cam0/cam1, 752x480).
    _EUROC_K = np.array([[458.654, 0, 367.215], [0, 457.296, 248.375], [0, 0, 1.0]])
    _EUROC_K_R = np.array([[457.587, 0, 379.999], [0, 456.134, 255.238], [0, 0, 1.0]])
    _EUROC_D = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0])
    _EUROC_D_R = np.array([-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05, 0.0])
    #: cam0_T_cam1 for the standard rig (from the dataset's sensor.yaml chain).
    _EUROC_C0_T_C1 = np.array(
        [
            [0.99999774, 0.00231714, 0.00037600, 0.11007381],
            [-0.00231092, 0.99989247, -0.01447005, -0.00039912],
            [-0.00040953, 0.01446906, 0.99989524, -0.00084799],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )

    def __init__(
        self,
        root: str | Path,
        name: str | None = None,
        read_imu: bool = True,
        intrinsics: list[Intrinsics] | None = None,
        max_frames: int | None = None,
    ) -> None:
        self._root = Path(root)
        mav = self._root / "mav0"
        if not mav.exists():
            raise FileNotFoundError(f"Not a EuRoC sequence (no mav0/): {root}")
        self._name = name or self._root.name
        self._read_imu = read_imu
        self._running = False
        self._idx = 0
        self._imu_idx = 0

        def read_cam(cam: str):
            entries = []
            with open(mav / cam / "data.csv") as f:
                for row in csv.reader(f):
                    if not row or row[0].startswith("#"):
                        continue
                    entries.append((int(row[0]) * 1e-9, mav / cam / "data" / row[1].strip()))
            return entries

        self._left = read_cam("cam0")
        self._right = read_cam("cam1")
        n = min(len(self._left), len(self._right))
        if max_frames:
            n = min(n, max_frames)
        self._left, self._right = self._left[:n], self._right[:n]

        self._imu: list[tuple[float, np.ndarray, np.ndarray]] = []
        imu_csv = mav / "imu0" / "data.csv"
        if read_imu and imu_csv.exists():
            with open(imu_csv) as f:
                for row in csv.reader(f):
                    if not row or row[0].startswith("#"):
                        continue
                    vals = [float(v) for v in row]
                    self._imu.append(
                        (vals[0] * 1e-9, np.asarray(vals[1:4]), np.asarray(vals[4:7]))
                    )

        # Calibration precedence: explicit override > mav0/calibration.npz
        # (our extension — written by scripts.make_euroc_synthetic so
        # generated sequences carry their exact calibration; absent in real
        # ASL datasets) > the standard EuRoC VI-sensor values.
        calib_npz = mav / "calibration.npz"
        c0_t_c1 = self._EUROC_C0_T_C1
        if intrinsics is not None:
            self._intr = intrinsics
        elif calib_npz.exists():
            z = np.load(calib_npz)
            w, h = int(z["width"]), int(z["height"])
            self._intr = [
                Intrinsics(width=w, height=h, matrix=z["k0"], coeffs=z["d0"]),
                Intrinsics(width=w, height=h, matrix=z["k1"], coeffs=z["d1"]),
            ]
            c0_t_c1 = z["c0_t_c1"]
        else:
            sample = _load_image(self._left[0][1])
            h, w = sample.shape[:2]
            self._intr = [
                Intrinsics(width=w, height=h, matrix=self._EUROC_K, coeffs=self._EUROC_D),
                Intrinsics(width=w, height=h, matrix=self._EUROC_K_R, coeffs=self._EUROC_D_R),
            ]
        self._ext = [
            Extrinsics.identity(),
            Extrinsics.from_4x4_matrix(c0_t_c1),
        ]

    @property
    def name(self) -> str:
        return self._name

    def start(self) -> None:
        self._running = True

    def stop(self) -> None:
        self._running = False

    def __len__(self) -> int:
        return len(self._left)

    @property
    def exhausted(self) -> bool:
        return self._idx >= len(self._left)

    def get_latest_frames(self) -> list[CameraFrame]:
        if not self._running:
            raise RuntimeError(f"Source {self._name} is not started")
        if self.exhausted:
            return []
        ts_l, path_l = self._left[self._idx]
        ts_r, path_r = self._right[self._idx]
        self._idx += 1
        return [
            CameraFrame(image=_load_image(path_l), timestamp=ts_l, sequence_num=self._idx - 1, camera_name=f"{self._name}_cam0"),
            CameraFrame(image=_load_image(path_r), timestamp=ts_r, sequence_num=self._idx - 1, camera_name=f"{self._name}_cam1"),
        ]

    def try_get_latest_frames(self) -> list[CameraFrame] | None:
        if not self._running or self.exhausted:
            return None
        return self.get_latest_frames()

    def get_intrinsics(self) -> list[Intrinsics]:
        return list(self._intr)

    def get_extrinsics(self) -> list[Extrinsics]:
        return list(self._ext)

    def get_sensor_extrinsics(self) -> Extrinsics | None:
        return Extrinsics.identity() if self._imu else None

    def get_timestamped_sensor_data(self) -> tuple[dict | None, float | None]:
        if not self._imu:
            return None, None
        # All IMU samples up to the frame this tick will DELIVER (index
        # self._idx), not the previously delivered one: the rig polls IMU
        # before frames (rig._poll_cameras), so cutting at the previous
        # frame's timestamp makes every preintegration window (t_{n-1},
        # t_n] arrive one tick late — i.e. always empty when the engine
        # packs it, silently disabling IMU fusion on the benchmark path.
        t_now = self._left[min(self._idx, len(self._left) - 1)][0]
        start = self._imu_idx
        while self._imu_idx < len(self._imu) and self._imu[self._imu_idx][0] <= t_now:
            self._imu_idx += 1
        if self._imu_idx == start:
            return None, None
        chunk = self._imu[start : self._imu_idx]
        ts = np.asarray([c[0] for c in chunk])
        gyro = np.stack([c[1] for c in chunk])
        accel = np.stack([c[2] for c in chunk])
        data = {
            "accelerometer": accel,
            "gyroscope": gyro,
            "timestamps": ts,
            "timestamp": float(ts[-1]),
            "sequence_num": self._imu_idx - 1,
        }
        return data, float(ts[-1])

    @property
    def has_sensor_data(self) -> bool:
        return bool(self._imu)


class RecordedCameraSource(CameraSource):
    """Replay of an npz-per-frame recording made by :func:`record_frames`."""

    def __init__(self, root: str | Path, name: str | None = None) -> None:
        self._root = Path(root)
        meta = np.load(self._root / "calibration.npz", allow_pickle=True)
        self._name = name or str(meta.get("name", self._root.name))
        self._intr = [
            Intrinsics(width=int(w), height=int(h), matrix=k, coeffs=c)
            for w, h, k, c in zip(meta["widths"], meta["heights"], meta["matrices"], meta["coeffs"])
        ]
        self._ext = [Extrinsics.from_4x4_matrix(m) for m in meta["extrinsics"]]
        self._sensor_ext = (
            Extrinsics.from_4x4_matrix(meta["sensor_extrinsics"])
            if "sensor_extrinsics" in meta.files
            else None
        )
        self._files = sorted(self._root.glob("frame_*.npz"))
        # IMU presence is a property of the recording, not the replay state:
        # peek at the first frame file's keys (cheap — npz key listing
        # reads only the zip directory).
        self._has_imu = bool(self._files) and "imu_timestamps" in np.load(self._files[0]).files
        self._pending_imu: tuple[dict, float] | None = None
        self._running = False
        self._idx = 0

    @property
    def name(self) -> str:
        return self._name

    def start(self) -> None:
        self._running = True

    def stop(self) -> None:
        self._running = False

    def __len__(self) -> int:
        return len(self._files)

    @property
    def exhausted(self) -> bool:
        return self._idx >= len(self._files)

    def get_latest_frames(self) -> list[CameraFrame]:
        if not self._running:
            raise RuntimeError(f"Source {self._name} is not started")
        if self.exhausted:
            return []
        data = np.load(self._files[self._idx])
        self._idx += 1
        if "imu_timestamps" in data.files:
            ts_arr = data["imu_timestamps"]
            self._pending_imu = (
                {
                    "accelerometer": data["imu_accelerometer"],
                    "gyroscope": data["imu_gyroscope"],
                    "timestamps": ts_arr,
                    "timestamp": float(ts_arr[-1]),
                    "sequence_num": self._idx - 1,
                },
                float(ts_arr[-1]),
            )
        frames = []
        for ci in range(len(self._intr)):
            frames.append(
                CameraFrame(
                    image=data[f"image_{ci}"],
                    timestamp=float(data["timestamp"]),
                    sequence_num=self._idx - 1,
                    camera_name=f"{self._name}_cam{ci}",
                )
            )
        return frames

    def try_get_latest_frames(self) -> list[CameraFrame] | None:
        if not self._running or self.exhausted:
            return None
        return self.get_latest_frames()

    def get_intrinsics(self) -> list[Intrinsics]:
        return list(self._intr)

    def get_extrinsics(self) -> list[Extrinsics]:
        return list(self._ext)

    def get_sensor_extrinsics(self) -> Extrinsics | None:
        return self._sensor_ext

    def get_timestamped_sensor_data(self) -> tuple[dict | None, float | None]:
        # Each frame's IMU batch is served exactly once, after that frame
        # is consumed — the cadence a live driver's queue drain exhibits.
        if self._pending_imu is None:
            return None, None
        data, ts = self._pending_imu
        self._pending_imu = None
        return data, ts

    @property
    def has_sensor_data(self) -> bool:
        return self._has_imu


def record_frames(source: CameraSource, out_dir: str | Path, num_frames: int) -> int:
    """Record a live source into the RecordedCameraSource layout.

    Captures frames AND, when the source reports sensor data, the IMU
    batch delivered alongside each frame group (timestamps, gyroscope,
    accelerometer) plus the IMU extrinsics — so a field capture replays
    through the full fusion path, not just the visual one. The reference
    has no capture/replay tooling at all (SURVEY.md §4).
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    intr = source.get_intrinsics()
    calib: dict = dict(
        name=source.name,
        widths=[i.width for i in intr],
        heights=[i.height for i in intr],
        matrices=[i.matrix for i in intr],
        coeffs=[i.coeffs for i in intr],
        extrinsics=[e.to_4x4_matrix() for e in source.get_extrinsics()],
    )
    sensor_ext = source.get_sensor_extrinsics()
    if sensor_ext is not None:
        calib["sensor_extrinsics"] = sensor_ext.to_4x4_matrix()
    np.savez_compressed(out / "calibration.npz", **calib)
    count = 0
    for k in range(num_frames):
        frames = source.get_latest_frames()
        if not frames:
            break
        arrays = {f"image_{ci}": f.image for ci, f in enumerate(frames)}
        if source.has_sensor_data:
            sd, _ = source.try_get_timestamped_sensor_data()
            if sd is not None and len(np.atleast_1d(sd["timestamps"])):
                arrays["imu_timestamps"] = np.atleast_1d(sd["timestamps"])
                arrays["imu_gyroscope"] = np.atleast_2d(sd["gyroscope"])
                arrays["imu_accelerometer"] = np.atleast_2d(sd["accelerometer"])
        np.savez_compressed(out / f"frame_{k:06d}.npz", timestamp=frames[0].timestamp, **arrays)
        count += 1
    return count
