"""Deterministic synthetic camera sources — the framework's test backbone.

The reference has no fake :class:`CameraSource` at all (its "tests" are
hardware-in-the-loop eyeball scripts; reference tests/ contains only a dummy
— see reference tests/test_dummy.py). This module provides what the rebuild
needs instead:

* :class:`SyntheticWorld` — a procedurally textured box room rendered by
  ray casting, giving photometrically consistent multi-view imagery with
  exact ground-truth geometry.
* :class:`OrbitTrajectory` — an analytic rig trajectory with closed-form
  poses and finite-difference IMU (gyro + specific force).
* :class:`SyntheticCameraSource` — a :class:`CameraSource` whose frames are
  deterministic functions of the frame index, with controllable frame rate,
  clock offset, and jitter (for exercising rig synchronization exactly).

Everything is seeded and hash-based: no global RNG state, identical output
across runs and platforms.

Copy of :mod:`thor_slam_tpu.camera.sources.synthetic`, kept in the port so that
the port imports nothing of the JAX package; keep the two in step.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from thor_slam_tpu_torch import geometry
from thor_slam_tpu_torch.camera.types import CameraFrame, CameraSource, Extrinsics, Intrinsics

GRAVITY_W = np.array([0.0, 0.0, -9.81])  # world gravity, z-up world frame


# ---------------------------------------------------------------------------
# Procedural texture (hash-based, deterministic, works for np or jnp arrays)
# ---------------------------------------------------------------------------

def _hash01(ix, iy, iz, seed: int, xp=np):
    """Integer lattice hash -> [0, 1) floats. Deterministic across platforms.

    uint32 wraparound is the hash — silence numpy's overflow warning (it
    fires on 0-d/scalar operands only; array ops wrap silently).
    """
    with np.errstate(over="ignore"):
        h = (
            ix.astype(xp.uint32) * xp.uint32(73856093)
            ^ iy.astype(xp.uint32) * xp.uint32(19349663)
            ^ iz.astype(xp.uint32) * xp.uint32(83492791)
            ^ xp.uint32(seed * 2654435761 & 0xFFFFFFFF)
        )
        h = h ^ (h >> xp.uint32(13))
        h = h * xp.uint32(0x5BD1E995)
        h = h ^ (h >> xp.uint32(15))
    return h.astype(xp.float32) * xp.float32(1.0 / 4294967296.0)


# Fixed rotations applied to each octave's lattice: breaks the axis-aligned
# periodicity that would otherwise make every wall a perfect repeating grid
# (pathological for feature matching in a way real scenes are not).
_OCTAVE_ROTATIONS = [
    np.array(
        [
            [np.cos(a) * np.cos(b), -np.sin(a), np.cos(a) * np.sin(b)],
            [np.sin(a) * np.cos(b), np.cos(a), np.sin(a) * np.sin(b)],
            [-np.sin(b), 0.0, np.cos(b)],
        ],
        dtype=np.float32,
    )
    for a, b in ((0.0, 0.0), (0.61, 0.23), (1.13, 0.77), (0.37, 1.41))
]


def procedural_texture(points, seed: int = 7, xp=np):
    """Multi-octave blocky 3D texture in [0, 1] at world-space ``points``.

    Nearest-neighbor (blocky) octaves create strong corner features that
    FAST-style detectors latch onto; per-octave lattice rotations and
    irrational scale ratios avoid degenerate repetition.
    ``points``: (..., 3) array.
    """
    out = None
    # (scale in cells/meter, weight per octave) — non-commensurate scales.
    for k, (scale, w) in enumerate(((2.03, 0.4), (5.19, 0.3), (12.67, 0.2), (30.71, 0.1))):
        rot = xp.asarray(_OCTAVE_ROTATIONS[k])
        p = points @ rot.T
        ix = xp.floor(p[..., 0] * scale).astype(xp.int32)
        iy = xp.floor(p[..., 1] * scale).astype(xp.int32)
        iz = xp.floor(p[..., 2] * scale).astype(xp.int32)
        v = _hash01(ix, iy, iz, seed + k, xp=xp) * w
        out = v if out is None else out + v
    return out


# ---------------------------------------------------------------------------
# World: a textured axis-aligned box room, rendered by ray casting
# ---------------------------------------------------------------------------

@dataclass
class SyntheticWorld:
    """An axis-aligned box room (camera inside) with procedural wall texture.

    Attributes:
        half_extents: Half sizes (hx, hy, hz) of the room in meters.
        seed: Texture seed.
    """

    half_extents: tuple[float, float, float] = (8.0, 8.0, 3.0)
    seed: int = 7

    def render(
        self,
        intrinsics: Intrinsics,
        world_t_cam: np.ndarray,
        xp=np,
    ):
        """Render a grayscale image from a camera pose.

        Args:
            intrinsics: Pinhole intrinsics (distortion ignored; render ideal).
            world_t_cam: 4x4 camera-to-world transform; camera frame is RDF
                (+x right, +y down, +z forward).
            xp: Array module (numpy for host, jax.numpy for on-device render).

        Returns:
            (H, W) float32 image in [0, 1].
        """
        w, h = intrinsics.width, intrinsics.height
        k = intrinsics.matrix
        fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]

        u = xp.arange(w, dtype=xp.float32) + 0.5
        v = xp.arange(h, dtype=xp.float32) + 0.5
        uu, vv = xp.meshgrid(u, v)  # (H, W)
        dirs_cam = xp.stack(
            [(uu - cx) / fx, (vv - cy) / fy, xp.ones_like(uu)], axis=-1
        )  # (H, W, 3) in RDF

        r_wc = xp.asarray(world_t_cam[:3, :3], dtype=xp.float32)
        origin = xp.asarray(world_t_cam[:3, 3], dtype=xp.float32)
        dirs_w = dirs_cam @ r_wc.T  # (H, W, 3)

        he = xp.asarray(self.half_extents, dtype=xp.float32)
        eps = xp.float32(1e-6)
        big = xp.float32(1e9)

        # Slab method specialized for "camera strictly inside the box":
        # along each axis the exit distance is t = (sign(d)*he - o) / d.
        d_safe = xp.where(xp.abs(dirs_w) < eps, eps, dirs_w)
        t_exit_per_axis = (xp.sign(d_safe) * he - origin) / d_safe  # (H, W, 3)
        t_exit_per_axis = xp.where(xp.abs(dirs_w) < eps, big, t_exit_per_axis)
        t_hit = xp.min(t_exit_per_axis, axis=-1)  # (H, W)

        hit = origin + dirs_w * t_hit[..., None]  # (H, W, 3)
        img = procedural_texture(hit, seed=self.seed, xp=xp)

        # Mild distance shading for photometric realism (keeps gradients).
        depth = t_hit * xp.sqrt(xp.sum(dirs_cam * dirs_cam, axis=-1))
        shade = 1.0 / (1.0 + 0.02 * depth)
        return xp.clip(img * (0.55 + 0.45 * shade) + 0.15, 0.0, 1.0).astype(xp.float32)

    def render_depth(self, intrinsics: Intrinsics, world_t_cam: np.ndarray, xp=np):
        """Ground-truth z-depth (meters) for the same camera model."""
        w, h = intrinsics.width, intrinsics.height
        k = intrinsics.matrix
        fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
        u = xp.arange(w, dtype=xp.float32) + 0.5
        v = xp.arange(h, dtype=xp.float32) + 0.5
        uu, vv = xp.meshgrid(u, v)
        dirs_cam = xp.stack([(uu - cx) / fx, (vv - cy) / fy, xp.ones_like(uu)], axis=-1)
        r_wc = xp.asarray(world_t_cam[:3, :3], dtype=xp.float32)
        origin = xp.asarray(world_t_cam[:3, 3], dtype=xp.float32)
        dirs_w = dirs_cam @ r_wc.T
        he = xp.asarray(self.half_extents, dtype=xp.float32)
        eps = xp.float32(1e-6)
        d_safe = xp.where(xp.abs(dirs_w) < eps, eps, dirs_w)
        t_exit = (xp.sign(d_safe) * he - origin) / d_safe
        t_exit = xp.where(xp.abs(dirs_w) < eps, xp.float32(1e9), t_exit)
        t_hit = xp.min(t_exit, axis=-1)
        return t_hit  # z-depth: dirs_cam z-component is 1, so t == depth along z


# ---------------------------------------------------------------------------
# Trajectory: analytic rig motion with finite-difference IMU
# ---------------------------------------------------------------------------

@dataclass
class OrbitTrajectory:
    """Smooth orbit inside the room: closed-form pose, differentiable IMU.

    The rig (body) frame is FLU (+x forward, +y left, +z up); the world is
    z-up. Yaw tracks the orbit tangent; gentle roll/pitch/height oscillation
    exercises full 6-DoF estimation.
    """

    radius: float = 3.0
    angular_rate: float = 0.25  # rad/s around the orbit
    height: float = 0.0
    height_amplitude: float = 0.3
    height_rate: float = 0.7
    rp_amplitude: float = 0.06  # roll/pitch oscillation, radians
    rp_rate: float = 0.9

    def pose(self, t: float) -> np.ndarray:
        """world_T_body (FLU body) at time ``t`` as a 4x4 matrix."""
        a = self.angular_rate * t
        pos = np.array(
            [
                self.radius * np.cos(a),
                self.radius * np.sin(a),
                self.height + self.height_amplitude * np.sin(self.height_rate * t),
            ]
        )
        yaw = a + np.pi / 2.0  # tangent direction
        roll = self.rp_amplitude * np.sin(self.rp_rate * t)
        pitch = self.rp_amplitude * np.cos(self.rp_rate * t * 0.8)
        r = geometry.euler_xyz_extrinsic_to_matrix(roll, pitch, yaw)
        return geometry.se3_matrix(r, pos)

    def velocity(self, t: float, dt: float = 1e-4) -> np.ndarray:
        """World-frame linear velocity by central differences."""
        p0 = self.pose(t - dt)[:3, 3]
        p1 = self.pose(t + dt)[:3, 3]
        return (p1 - p0) / (2.0 * dt)

    def imu_sample(self, t: float, dt: float = 1e-4) -> tuple[np.ndarray, np.ndarray]:
        """(gyro, accel) in the body frame at time ``t``.

        gyro: angular velocity (rad/s). accel: specific force (m/s^2),
        i.e. body-frame acceleration minus gravity — what a real
        accelerometer measures.
        """
        m0 = self.pose(t - dt)
        m1 = self.pose(t)
        m2 = self.pose(t + dt)
        r0, r1, r2 = m0[:3, :3], m1[:3, :3], m2[:3, :3]
        # Angular velocity from the skew part of R^T dR/dt.
        dr = (r2 - r0) / (2.0 * dt)
        omega_skew = r1.T @ dr
        gyro = np.array([omega_skew[2, 1], omega_skew[0, 2], omega_skew[1, 0]])
        # Linear acceleration in world by second differences.
        acc_w = (m2[:3, 3] - 2.0 * m1[:3, 3] + m0[:3, 3]) / (dt * dt)
        accel = r1.T @ (acc_w - GRAVITY_W)
        return gyro, accel


# FLU body -> RDF optical: optical z (forward) = body x, optical x (right) =
# -body y, optical y (down) = -body z. This is cam_R_body... we store
# body_T_optical (columns = optical axes in body coords).
BODY_T_OPTICAL = np.array(
    [
        [0.0, 0.0, 1.0, 0.0],
        [-1.0, 0.0, 0.0, 0.0],
        [0.0, -1.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ]
)


# ---------------------------------------------------------------------------
# Synthetic camera source
# ---------------------------------------------------------------------------

@dataclass
class SyntheticRigSpec:
    """Layout of a synthetic multi-camera rig."""

    num_sources: int = 4
    stereo: bool = True
    width: int = 640
    height: int = 400
    baseline_m: float = 0.075
    fps: float = 30.0
    imu_rate_hz: float = 400.0
    focal_scale: float = 0.8  # fx = focal_scale * width
    # Yaw of each source's mount around the rig +z, evenly spaced by default.
    mount_yaws: tuple[float, ...] | None = None
    seed: int = 7
    # Optional COLOR imager (the RGB-D leg's CAM_A counterpart): offset
    # from the left imager in the optical frame, with its own resolution.
    color_camera: bool = False
    color_resolution: tuple[int, int] | None = None
    # --- Robustness nuisances (all deterministic per frame index) -------
    # Sensor non-idealities for accuracy ablations: the benchmark ATE
    # table should degrade gracefully under each (BASELINE.md), not only
    # on the clean renderer the package itself produced.
    #: Sinusoidal exposure/gain drift amplitude (fraction of nominal;
    #: e.g. 0.3 swings brightness between 0.7x and 1.3x).
    exposure_drift: float = 0.0
    exposure_period_s: float = 4.0
    #: Additive Gaussian intensity noise std on the 0-255 scale.
    noise_std: float = 0.0
    #: Per-pixel salt-and-pepper probability (half white, half black).
    salt_prob: float = 0.0
    #: Motion blur: horizontal box-blur length = this many pixels per
    #: rad/s of body yaw rate (approximates rotational smear over the
    #: exposure; 0 disables).
    motion_blur_px_per_rad_s: float = 0.0
    #: Constant gyro bias injected into emitted IMU samples (rad/s, IMU
    #: frame) — the bias-estimation benchmark fixture.
    imu_gyro_bias: tuple[float, float, float] = (0.0, 0.0, 0.0)
    color_offset_m: tuple[float, float, float] = (0.0375, -0.002, 0.0)


def _default_intrinsics(spec: SyntheticRigSpec) -> Intrinsics:
    f = spec.focal_scale * spec.width
    k = np.array(
        [[f, 0.0, spec.width / 2.0], [0.0, f, spec.height / 2.0], [0.0, 0.0, 1.0]]
    )
    return Intrinsics(width=spec.width, height=spec.height, matrix=k, coeffs=np.zeros(5))


class SyntheticCameraSource(CameraSource):
    """A deterministic stereo/mono camera rendering the synthetic world.

    Frame ``n`` is captured at ``t = n / fps + clock_offset + jitter(n)``
    (simulation clock, not wall clock): every run produces bit-identical
    streams. ``get_latest_frames`` / ``try_get_latest_frames`` both advance
    the stream by one frame — availability is simulated, not timed.

    IMU: when ``emit_imu`` is set, ``get_timestamped_sensor_data`` returns a
    *batched* sample dict — ``accelerometer``/``gyroscope`` of shape [N, 3]
    and ``timestamps`` of shape [N] — covering all IMU ticks since the last
    poll (mirrors DepthAI's IMU packet batching, reference
    luxonis.py:570-591). Single-sample consumers should use the last row.
    """

    def __init__(
        self,
        name: str,
        world: SyntheticWorld,
        trajectory: OrbitTrajectory,
        rig_t_source: np.ndarray,
        spec: SyntheticRigSpec,
        clock_offset: float = 0.0,
        jitter_std: float = 0.0,
        emit_imu: bool = False,
        render: bool = True,
        imu_clock_offset: float | None = None,
    ) -> None:
        self._name = name
        self._world = world
        self._traj = trajectory
        self._rig_t_source = rig_t_source
        self._spec = spec
        self._clock_offset = clock_offset
        self._jitter_std = jitter_std
        # Fault injection: stamp IMU samples on a DIFFERENT clock than the
        # frames (the mixed-clock hardware pairing the rig's bring-up guard
        # exists to catch). None = IMU shares the frame clock.
        self._imu_clock_offset = clock_offset if imu_clock_offset is None else imu_clock_offset
        self._emit_imu = emit_imu
        self._render = render
        self._running = False
        self._frame_idx = 0
        self._imu_idx = 0
        self._intr = _default_intrinsics(spec)
        # Optical-frame offsets: left at origin, right displaced along
        # optical +x (RDF) by the baseline.
        self._optical_offsets = [np.eye(4)]
        if spec.stereo:
            right = np.eye(4)
            right[0, 3] = spec.baseline_m
            self._optical_offsets.append(right)
        # Public extrinsics are source_T_cam with the source frame being the
        # FLU bracket/body frame (so RigCalibration.get_world_extrinsics =
        # rig_T_source @ source_T_cam yields true optical poses in the rig).
        self._cam_extrinsics = [
            Extrinsics.from_4x4_matrix(BODY_T_OPTICAL @ off) for off in self._optical_offsets
        ]
        # Optional color imager (RGB-D leg): its own optical offset,
        # resolution and intrinsics, independent of the SLAM stream.
        self._color_offset = None
        self._color_intr = None
        if spec.color_camera:
            off = np.eye(4)
            off[:3, 3] = spec.color_offset_m
            self._color_offset = off
            cw, ch = spec.color_resolution or (spec.width, spec.height)
            f = spec.focal_scale * cw
            k = np.array([[f, 0.0, cw / 2.0], [0.0, f, ch / 2.0], [0.0, 0.0, 1.0]])
            self._color_intr = Intrinsics(width=cw, height=ch, matrix=k, coeffs=np.zeros(5))

    # -- CameraSource contract ------------------------------------------------

    @property
    def name(self) -> str:
        return self._name

    def start(self) -> None:
        self._running = True

    def stop(self) -> None:
        self._running = False

    def _jitter(self, n: int) -> float:
        if self._jitter_std <= 0.0:
            return 0.0
        # Distinct per-camera stream: fold the source name into the lattice.
        name_key = np.int32(sum(ord(c) * (i + 1) for i, c in enumerate(self._name)) & 0x7FFFFFFF)
        h = _hash01(np.int32(n), name_key, np.int32(17), seed=self._spec.seed)
        # Map uniform [0,1) to roughly normal via sum of two uniforms - 1.
        h2 = _hash01(np.int32(n * 7 + 3), name_key, np.int32(23), seed=self._spec.seed)
        return float((h + h2) - 1.0) * self._jitter_std * 1.732

    def frame_time(self, n: int) -> float:
        """Capture timestamp of frame ``n`` on this source's clock."""
        return n / self._spec.fps + self._clock_offset + self._jitter(n)

    def world_t_optical(self, t: float, cam_idx: int) -> np.ndarray:
        """Ground-truth world pose of imager ``cam_idx`` at time ``t``."""
        world_t_body = self._traj.pose(t)
        return world_t_body @ self._rig_t_source @ self._cam_extrinsics[cam_idx].to_4x4_matrix()

    def world_t_color(self, t: float) -> np.ndarray:
        """Ground-truth world pose of the color imager at time ``t``."""
        assert self._color_offset is not None
        world_t_body = self._traj.pose(t)
        return (
            world_t_body @ self._rig_t_source
            @ Extrinsics.from_4x4_matrix(BODY_T_OPTICAL @ self._color_offset).to_4x4_matrix()
        )

    def get_rgb_intrinsics(self) -> Intrinsics | None:
        """Color-imager intrinsics (None when no color leg is configured).

        Same duck-typed surface as the hardware source
        (LuxonisCameraSource.get_rgb_intrinsics).
        """
        return self._color_intr

    def get_rgb_extrinsics(self) -> Extrinsics | None:
        """Pose of the color imager in the LEFT imager's (raw) frame."""
        if self._color_offset is None:
            return None
        return Extrinsics.from_4x4_matrix(self._color_offset)

    def render_color_frame(self, n: int) -> np.ndarray:
        """Deterministic (H, W, 3) uint8 color frame ``n``."""
        assert self._color_intr is not None
        t = self.frame_time(n)
        img = self._world.render(self._color_intr, self.world_t_color(t))
        gray = (np.asarray(img) * 255.0).astype(np.uint8)
        return np.stack([gray, gray, gray], axis=-1)

    def render_color_depth(self, n: int) -> np.ndarray:
        """Ground-truth depth along the COLOR imager's rays (test fixture)."""
        assert self._color_intr is not None
        t = self.frame_time(n)
        return np.asarray(self._world.render_depth(self._color_intr, self.world_t_color(t)))

    def try_get_latest_rgb_frame(self) -> CameraFrame | None:
        """Color frame paired with the most recently delivered stereo tick."""
        if not self._running or self._color_offset is None or self._frame_idx == 0:
            return None
        n = self._frame_idx - 1
        return CameraFrame(
            image=self.render_color_frame(n),
            timestamp=self.frame_time(n),
            sequence_num=n,
            camera_name=f"{self._name}_rgb",
        )

    def render_frame(self, n: int, cam_idx: int) -> np.ndarray:
        """Deterministically render frame ``n`` for one imager as uint8.

        Applies the spec's nuisance chain (motion blur -> exposure drift
        -> Gaussian noise -> salt & pepper) with a per-(frame, imager)
        seeded RNG, so sequences are bit-reproducible.
        """
        t = self.frame_time(n)
        arr = np.asarray(
            self._world.render(self._intr, self.world_t_optical(t, cam_idx)),
            np.float32,
        )
        spec = self._spec
        if spec.motion_blur_px_per_rad_s > 0.0:
            # Yaw rate from the trajectory (finite difference); dominant
            # image motion for a yawing rig is horizontal smear.
            dt = 0.005
            r0 = self._traj.pose(t - dt)[:3, :3]
            r1 = self._traj.pose(t + dt)[:3, :3]
            rel = r0.T @ r1
            ang = float(
                np.arccos(np.clip(0.5 * (np.trace(rel) - 1.0), -1.0, 1.0))
            ) / (2 * dt)
            taps = int(np.clip(round(spec.motion_blur_px_per_rad_s * ang), 1, 15))
            if taps > 1:
                pad = taps // 2
                padded = np.pad(arr, ((0, 0), (pad, taps - 1 - pad)), mode="edge")
                # Horizontal box filter via cumulative sum (vectorized).
                cs = np.cumsum(padded, axis=1, dtype=np.float64)
                cs = np.concatenate([np.zeros((arr.shape[0], 1)), cs], axis=1)
                arr = ((cs[:, taps:] - cs[:, :-taps]) / taps).astype(np.float32)
        if spec.exposure_drift > 0.0:
            gain = 1.0 + spec.exposure_drift * np.sin(
                2.0 * np.pi * t / spec.exposure_period_s
            )
            arr = arr * np.float32(gain)
        if spec.noise_std > 0.0 or spec.salt_prob > 0.0:
            import zlib

            # Stable seed (Python's str hash is salted per process).
            rng = np.random.default_rng(
                (
                    zlib.crc32(self._name.encode())
                    + 1000003 * int(n)
                    + 7919 * int(cam_idx)
                    + spec.seed
                )
                & 0x7FFFFFFF
            )
            if spec.noise_std > 0.0:
                arr = arr + rng.normal(
                    0.0, spec.noise_std / 255.0, arr.shape
                ).astype(np.float32)
            if spec.salt_prob > 0.0:
                u = rng.random(arr.shape)
                arr = np.where(u < 0.5 * spec.salt_prob, 0.0, arr)
                arr = np.where(u > 1.0 - 0.5 * spec.salt_prob, 1.0, arr)
        return np.clip(arr * 255.0, 0.0, 255.0).astype(np.uint8)

    def _make_frames(self, n: int) -> list[CameraFrame]:
        t = self.frame_time(n)
        frames = []
        for ci in range(len(self._cam_extrinsics)):
            if self._render:
                img = self.render_frame(n, ci)
            else:
                img = np.zeros((self._spec.height, self._spec.width), dtype=np.uint8)
            frames.append(
                CameraFrame(image=img, timestamp=t, sequence_num=n, camera_name=f"{self._name}_cam{ci}")
            )
        return frames

    def get_latest_frames(self) -> list[CameraFrame]:
        if not self._running:
            raise RuntimeError(f"Source {self._name} is not started")
        frames = self._make_frames(self._frame_idx)
        self._frame_idx += 1
        return frames

    def try_get_latest_frames(self) -> list[CameraFrame] | None:
        if not self._running:
            return None
        return self.get_latest_frames()

    def get_intrinsics(self) -> list[Intrinsics]:
        return [self._intr for _ in self._cam_extrinsics]

    def get_extrinsics(self) -> list[Extrinsics]:
        return list(self._cam_extrinsics)

    def get_sensor_extrinsics(self) -> Extrinsics | None:
        if not self._emit_imu:
            return None
        # IMU co-located with the source origin (identity in source frame).
        return Extrinsics.identity()

    def get_timestamped_sensor_data(self) -> tuple[dict | None, float | None]:
        if not self._emit_imu:
            return None, None
        # All IMU ticks from the last poll up to the current frame clock.
        t_now = self._frame_idx / self._spec.fps + self._clock_offset
        n_end = int(np.floor(t_now * self._spec.imu_rate_hz))
        if n_end <= self._imu_idx:
            return None, None
        ticks = np.arange(self._imu_idx, n_end)
        self._imu_idx = n_end
        # Physical sample times ride the true (frame) clock; the *stamps*
        # may be skewed onto another clock (imu_clock_offset fault knob).
        ts = ticks / self._spec.imu_rate_hz + self._imu_clock_offset
        true_ts = ticks / self._spec.imu_rate_hz + self._clock_offset
        gyros, accels = [], []
        bias = np.asarray(self._spec.imu_gyro_bias, np.float64)
        for t in true_ts:
            g, a = self._traj.imu_sample(float(t))
            gyros.append(g + bias)  # sensor-bias fault knob (spec)
            accels.append(a)
        data = {
            "accelerometer": np.stack(accels),
            "gyroscope": np.stack(gyros),
            "timestamps": ts,
            "timestamp": float(ts[-1]),
            "sequence_num": int(ticks[-1]),
        }
        return data, float(ts[-1])

    @property
    def has_sensor_data(self) -> bool:
        return self._emit_imu


def make_synthetic_rig(
    spec: SyntheticRigSpec | None = None,
    world: SyntheticWorld | None = None,
    trajectory: OrbitTrajectory | None = None,
    clock_offsets: tuple[float, ...] | None = None,
    jitter_std: float = 0.0,
    render: bool = True,
) -> tuple[list[SyntheticCameraSource], dict[str, Extrinsics], SyntheticWorld, OrbitTrajectory]:
    """Build a full synthetic rig: N stereo sources mounted at spread yaws.

    Returns:
        (sources, rig_extrinsics, world, trajectory). Source names follow the
        reference's IP-as-name convention ("192.168.2.2<i>").
    """
    spec = spec or SyntheticRigSpec()
    world = world or SyntheticWorld(seed=spec.seed)
    trajectory = trajectory or OrbitTrajectory()
    yaws = spec.mount_yaws or tuple(
        2.0 * np.pi * i / spec.num_sources for i in range(spec.num_sources)
    )
    sources: list[SyntheticCameraSource] = []
    rig_extrinsics: dict[str, Extrinsics] = {}
    for i in range(spec.num_sources):
        name = f"192.168.2.2{i + 1}"
        mount = geometry.se3_matrix(
            geometry.euler_xyz_extrinsic_to_matrix(0.0, 0.0, yaws[i]),
            np.array([0.12 * np.cos(yaws[i]), 0.12 * np.sin(yaws[i]), 0.0]),
        )
        offset = 0.0 if clock_offsets is None else clock_offsets[i]
        sources.append(
            SyntheticCameraSource(
                name=name,
                world=world,
                trajectory=trajectory,
                rig_t_source=mount,
                spec=spec,
                clock_offset=offset,
                jitter_std=jitter_std,
                emit_imu=(i == 0),
                render=render,
            )
        )
        rig_extrinsics[name] = Extrinsics.from_4x4_matrix(mount)
    return sources, rig_extrinsics, world, trajectory
