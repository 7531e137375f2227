"""IMU fusion backend: buffering, gravity and gyro-bias estimation, prediction.

Port of :mod:`thor_slam_tpu.engine.backends.imu_fusion` against the port's
:mod:`thor_slam_tpu_torch.engine.imu` (the reference reaches JAX through
its package and its ``imu`` module). Everything here is host scalar math
on finalized data: a window holds at most 64 samples.

Owns the finalized-pose shadow: the last pose, timestamp and velocity the
host has finalized. Every prediction integrates from the shadow, never
from the live device state.
"""

from __future__ import annotations

import logging

import numpy as np

from thor_slam_tpu_torch import geometry
from thor_slam_tpu_torch.engine import imu as imu_mod

logger = logging.getLogger(__name__)

#: Gravity-filter process noise for odom-frame attitude drift,
#: (m/s^2)^2 per second: VO yaw/pitch drift slowly rotates the frame the
#: gravity vector is expressed in, so the filter keeps a gain floor
#: (alpha_ss = sqrt(Q dt / R) ~ 0.005 per window at 30 fps and 2 mm solve
#: noise).
GRAVITY_DRIFT_Q = 9.8e-3

IMU_NOISE_KEYS = frozenset(
    {
        "gyro_noise_density", "gyro_random_walk", "accel_noise_density",
        "accel_random_walk", "vis_rot_sigma", "vis_pos_sigma", "estimate_gyro_bias",
    }
)


def _rot_log_np(r: np.ndarray) -> np.ndarray:
    """SO(3) log map (numpy): rotation matrix -> axis-angle vector."""
    q = geometry.matrix_to_quat(np.asarray(r, np.float64))
    if q[3] < 0.0:
        q = -q
    s = float(np.linalg.norm(q[:3]))
    if s < 1e-12:
        return np.zeros(3)
    return q[:3] * (2.0 * np.arctan2(s, float(q[3])) / s)


class ImuFusion:
    """IMU ingest + online gravity/bias estimation + pose prediction.

    The noise model defaults to the reference's measured OAK-D Pro densities
    (the ``engine.imu`` constants): the gyro density and random walk set the
    gyro-bias Kalman gain, the accel density and random walk the gravity
    filter's gain, and the densities grow the held-pose covariance over
    untracked windows (:meth:`window_covariance`).

    Args:
        body_r_imu: (3, 3) rotation IMU -> body frame.
        use_accel: Enable the accelerometer path (gravity estimate +
            Forster translation prediction); gyro-only otherwise.
        gravity_min_ticks: Gravity observations required before the accel
            term engages.
        capacity: Raw-sample ring length.
        pred_capacity: Preintegration-window size (samples).
        gyro_noise_density, gyro_random_walk, accel_noise_density,
        accel_random_walk: Noise densities; None = the declared defaults.
        vis_rot_sigma: Per-solve visual rotation error std (rad).
        vis_pos_sigma: Per-solve visual position error std (m).
        estimate_gyro_bias: Estimate the gyro bias online from visual-vs-gyro
            window rotation residuals.
    """

    def __init__(
        self,
        body_r_imu: np.ndarray | None = None,
        use_accel: bool = True,
        gravity_min_ticks: int = 30,
        capacity: int = 256,
        pred_capacity: int = 64,
        gyro_noise_density: float | None = None,
        gyro_random_walk: float | None = None,
        accel_noise_density: float | None = None,
        accel_random_walk: float | None = None,
        vis_rot_sigma: float = 5e-4,
        vis_pos_sigma: float = 2e-3,
        estimate_gyro_bias: bool = True,
    ) -> None:
        def pick(value, default):
            return default if value is None else float(value)

        self.body_r_imu = np.eye(3) if body_r_imu is None else np.asarray(body_r_imu, np.float64)
        self.use_accel = use_accel
        self._gravity_min_ticks = int(gravity_min_ticks)
        self._capacity = capacity
        self._pred_capacity = pred_capacity
        self.gyro_nd = pick(gyro_noise_density, imu_mod.GYRO_NOISE_DENSITY)
        self.gyro_rw = pick(gyro_random_walk, imu_mod.GYRO_RANDOM_WALK)
        self.accel_nd = pick(accel_noise_density, imu_mod.ACCEL_NOISE_DENSITY)
        self.accel_rw = pick(accel_random_walk, imu_mod.ACCEL_RANDOM_WALK)
        self.vis_rot_sigma = float(vis_rot_sigma)
        self.vis_pos_sigma = float(vis_pos_sigma)
        self.estimate_gyro_bias = bool(estimate_gyro_bias)
        self._ts: list[float] = []
        self._gyro: list[np.ndarray] = []
        self._accel: list[np.ndarray] = []
        self.reset()

    def reset(self) -> None:
        """Drop samples, the gravity/bias estimates, and the pose shadow."""
        self._ts, self._gyro, self._accel = [], [], []
        #: Gyro bias (IMU frame, rad/s) and its per-axis variance; the prior
        #: is (0.02 rad/s)^2, a typical MEMS turn-on bias.
        self.gyro_bias = np.zeros(3)
        self.bias_p = 4e-4
        #: Count of preintegration windows that held no samples.
        self.empty_windows = 0
        self.reset_shadow()

    def reset_shadow(self) -> None:
        """Invalidate the finalized-pose shadow after a pose discontinuity
        (relocalization, state restore). Gravity is expressed in the odom
        frame, which moved, so it restarts; the gyro bias survives."""
        self.fin_pose: np.ndarray | None = None
        self.fin_ts: float | None = None
        #: Instantaneous velocity at fin_ts (the prediction's term) and the
        #: last window's average (the gravity observation's).
        self.fin_vel = np.zeros(3)
        self._fin_vel_avg = np.zeros(3)
        self.fin_ts_prev: float | None = None
        # Correction epochs at the last two finalizes, compared by identity:
        # a BA correction inside the double difference would read as a
        # large spurious acceleration.
        self._fin_epoch = None
        self._fin_epoch_prev = None
        self.gravity_w: np.ndarray | None = None
        self.grav_p = 1e4
        self.gravity_n = 0

    # --------------------------------------------------------- ingest

    def ingest(self, sensor_data: dict, sensor_ts: float | None) -> None:
        """Buffer IMU samples (one sample dict or driver-batched arrays)."""
        raw_acc = sensor_data.get("accelerometer")
        raw_gyr = sensor_data.get("gyroscope")
        if raw_acc is None or raw_gyr is None:
            return
        acc = np.asarray(raw_acc, np.float64)
        gyr = np.asarray(raw_gyr, np.float64)
        if acc.ndim == 2:  # batched packet
            raw_ts = sensor_data.get("timestamps")
            ts = None if raw_ts is None else np.asarray(raw_ts, np.float64)
            if ts is not None and len(ts) < acc.shape[0]:
                return  # malformed batch: fewer timestamps than samples
            for i in range(acc.shape[0]):
                t = float(ts[i]) if ts is not None else (sensor_ts or 0.0)
                if not self._ts or t > self._ts[-1]:
                    self._ts.append(t)
                    self._gyro.append(gyr[i])
                    self._accel.append(acc[i])
        else:
            t = float(sensor_data.get("timestamp", sensor_ts or 0.0))
            if not self._ts or t > self._ts[-1]:
                self._ts.append(t)
                self._gyro.append(gyr)
                self._accel.append(acc)
        if len(self._ts) > self._capacity:
            del self._ts[: -self._capacity]
            del self._gyro[: -self._capacity]
            del self._accel[: -self._capacity]

    @property
    def num_samples(self) -> int:
        return len(self._ts)

    def _window(self, t_start: float, t_end: float):
        return imu_mod.pack_imu_window(
            self._ts, self._gyro, self._accel, t_start=t_start, t_end=t_end,
            capacity=self._pred_capacity,
        )

    # --------------------------------------------- finalized-pose shadow

    def on_finalized(self, world_t_body: np.ndarray, ts: float, tracked: bool, epoch) -> None:
        """Advance the shadow with one finalized odom-frame pose.

        Only tracked solves observe bias and gravity; ``epoch`` is the
        current correction-epoch object (compared by identity).
        """
        if self.fin_ts is not None and ts > self.fin_ts:
            dt = ts - self.fin_ts
            v_avg = (world_t_body[:3, 3] - self.fin_pose[:3, 3]) / dt
            g_, a_, d_, m_ = self._window(self.fin_ts, ts)
            if self.estimate_gyro_bias and tracked and self._fin_epoch is epoch and m_.sum() >= 3:
                self._observe_gyro_bias(world_t_body, g_, d_, m_, dt)
            if (
                self.use_accel
                and self.fin_ts_prev is not None
                and tracked
                and self._fin_epoch_prev is epoch
            ):
                self._observe_gravity(v_avg, ts)
            # Half-step propagation: v_avg lags v(ts) by ~a dt / 2, with
            # a dt = g dt + R0 delta_v once the gravity estimate is live.
            v_inst = v_avg
            if self.accel_pred_active() and m_.sum() >= 1:
                pre = imu_mod.preintegrate_fast_np(g_, a_, d_, m_, gyro_bias=self.gyro_bias)
                v_inst = v_avg + 0.5 * (
                    self.gravity_w * dt + self.fin_pose[:3, :3] @ (self.body_r_imu @ pre.delta_v)
                )
            self.fin_ts_prev = self.fin_ts
            self._fin_epoch_prev = self._fin_epoch
            self.fin_vel = v_inst
            self._fin_vel_avg = v_avg
        self.fin_pose = world_t_body
        self.fin_ts = ts
        self._fin_epoch = epoch

    def on_correction(self, world_t_body: np.ndarray, t_corr: np.ndarray, epoch) -> None:
        """A BA correction moved the live state: re-anchor the shadow there
        (the velocity rotates like a free vector)."""
        self.fin_pose = world_t_body
        self._fin_epoch = epoch
        self.fin_vel = t_corr[:3, :3] @ self.fin_vel

    # ---------------------------------------------------- gyro bias

    def _observe_gyro_bias(self, world_t_body, g_, d_, m_, dt: float) -> None:
        """Kalman-update the gyro bias from one finalized window.

        The raw-gyro rotation over-rotates the visual one by ~Exp(b tau);
        the visual log-rotation is rescaled to the samples' coverage tau
        before differencing. Observation variance: two solved endpoint
        rotations plus the integrated gyro white noise; the state
        random-walks at gyro_rw^2 tau.
        """
        tau = float(d_.sum())
        if tau < 0.5 * dt or tau <= 1e-6:
            return  # samples cover too little of the pose gap
        dr_gyro = imu_mod.gyro_delta_r_np(g_, d_, m_)  # IMU frame, raw
        rbi = self.body_r_imu
        dr_vis = rbi.T @ (self.fin_pose[:3, :3].T @ world_t_body[:3, :3]) @ rbi
        phi_vis = _rot_log_np(dr_vis) * (tau / dt)
        b_obs = (_rot_log_np(dr_gyro) - phi_vis) / tau
        if float(np.linalg.norm(b_obs - self.gyro_bias)) > 0.5:
            return  # junk gate (rad/s)
        r_meas = 2.0 * (self.vis_rot_sigma / tau) ** 2 + self.gyro_nd**2 / tau
        self.bias_p += self.gyro_rw**2 * tau
        k = self.bias_p / (self.bias_p + r_meas)
        self.gyro_bias = self.gyro_bias + k * (b_obs - self.gyro_bias)
        self.bias_p *= 1.0 - k

    # ------------------------------------------------------ gravity

    def _observe_gravity(self, v_new: np.ndarray, ts: float) -> None:
        """Kalman-update the odom-frame gravity estimate.

        Differenced average velocities of two consecutive windows measure
        the world acceleration between their midpoints; subtracting the
        rotated mean specific force leaves ``g = a_w - R f`` under any
        motion. Observation variance: double-differenced solve noise
        (4 vis_pos_sigma^2 / dt^4) plus accel white noise; the state
        random-walks at the accel-bias walk plus GRAVITY_DRIFT_Q.
        """
        m0 = 0.5 * (self.fin_ts_prev + self.fin_ts)
        m1 = 0.5 * (self.fin_ts + ts)
        dt = m1 - m0
        if dt <= 1e-6 or not self._ts:
            return
        ts_arr = np.asarray(self._ts)
        sel = (ts_arr > m0) & (ts_arr <= m1)
        if not np.any(sel):
            return
        f_imu = np.mean(np.asarray(self._accel)[sel], axis=0)
        a_w = (v_new - self._fin_vel_avg) / dt
        g_obs = a_w - self.fin_pose[:3, :3] @ (self.body_r_imu @ f_imu)
        # Junk-only guard: a tight norm gate would clip the zero-mean noise
        # asymmetrically and bias the estimate low.
        if float(np.linalg.norm(g_obs)) > 60.0:
            return
        r_meas = 4.0 * self.vis_pos_sigma**2 / dt**4 + self.accel_nd**2 / dt
        if self.gravity_w is None:
            self.gravity_w = g_obs
            self.grav_p = r_meas
        else:
            self.grav_p += (self.accel_rw**2 + GRAVITY_DRIFT_Q) * dt
            k = self.grav_p / (self.grav_p + r_meas)
            self.gravity_w = self.gravity_w + k * (g_obs - self.gravity_w)
            self.grav_p *= 1.0 - k
        self.gravity_n += 1

    def window_covariance(self, dt: float) -> np.ndarray:
        """(6, 6) [position, orientation] covariance growth over one
        untracked window of ``dt`` seconds, from the declared noise model:
        rotation = gyro white noise + bias uncertainty; translation =
        velocity-estimate noise (two solved endpoints) + gravity
        uncertainty and accel noise, double-integrated."""
        dt = max(float(dt), 1e-4)
        rot_var = self.gyro_nd**2 * dt + float(self.bias_p) * dt * dt
        grav_p = float(self.grav_p) if self.gravity_w is not None else 0.0
        pos_var = 2.0 * self.vis_pos_sigma**2 + grav_p * (0.5 * dt * dt) ** 2 + self.accel_nd**2 * dt**3
        return np.diag([pos_var] * 3 + [rot_var] * 3)

    def accel_pred_active(self) -> bool:
        """Whether the accel term of the pose prediction is engaged."""
        return (
            self.use_accel
            and self.gravity_w is not None
            and self.gravity_n >= self._gravity_min_ticks
            and 8.0 < float(np.linalg.norm(self.gravity_w)) < 12.0
        )

    # ----------------------------------------------------- prediction

    def predict(self, ts: float) -> np.ndarray | None:
        """(4, 4) float32 IMU pose prediction at ``ts`` from the shadow.

        Rotation is always gyro-preintegrated. Translation is the
        constant-velocity extrapolation until the gravity estimate has
        converged, then the full Forster form
        ``p + v dt + 1/2 g dt^2 + R delta_p``.
        """
        if self.fin_ts is None or len(self._ts) < 2:
            return None
        g, a, d, m = self._window(self.fin_ts, ts)
        if m.sum() < 1:
            # A dead IMU path must be visible: the engine otherwise degrades
            # to constant velocity without a word.
            self.empty_windows += 1
            if self.empty_windows in (10, 100) or self.empty_windows % 1000 == 0:
                logger.warning(
                    "IMU enabled but %d preintegration windows were empty — "
                    "samples may be arriving late or not at all",
                    self.empty_windows,
                )
            return None
        rbi = self.body_r_imu
        accel_active = self.accel_pred_active()
        if accel_active:
            pre = imu_mod.preintegrate_fast_np(g, a, d, m, gyro_bias=self.gyro_bias)
            delta_r_body = rbi @ pre.delta_r @ rbi.T
        else:
            delta_r_body = rbi @ imu_mod.gyro_delta_r_np(g, d, m, gyro_bias=self.gyro_bias) @ rbi.T
        fin = self.fin_pose
        pred = np.eye(4)
        pred[:3, :3] = fin[:3, :3] @ delta_r_body
        pred[:3, 3] = fin[:3, 3] + self.fin_vel * (ts - self.fin_ts)
        if accel_active:
            # delta_p spans the samples' coverage pre.dt; the
            # constant-velocity term above covers the whole (fin_ts, ts].
            pred[:3, 3] += 0.5 * self.gravity_w * pre.dt * pre.dt + fin[:3, :3] @ (rbi @ pre.delta_p)
        return pred.astype(np.float32)
