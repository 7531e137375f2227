"""Covariance growth of a held (untracked) pose, from the IMU noise model.

When a tick's solve lacks support the tracker keeps the predicted pose,
and the engine reports the last trusted covariance grown by the
prediction's own uncertainty. This is the diagonal model of the
reference's ``ImuFusion.window_covariance`` with its default densities
(the OAK-D Pro figures of ``thor_slam_tpu/engine/imu.py``) and its state
with no IMU samples: no gravity estimate, the prior gyro-bias variance.
"""

from __future__ import annotations

import numpy as np

GYRO_NOISE_DENSITY = 8.272e-5  # rad/s/sqrt(Hz)
ACCEL_NOISE_DENSITY = 2.553e-3  # m/s^2/sqrt(Hz)
VIS_POS_SIGMA = 2e-3  # per-solve visual position error std (m)
GYRO_BIAS_VAR = 4e-4  # prior gyro-bias variance ((rad/s)^2)


def window_covariance(dt: float) -> np.ndarray:
    """(6, 6) [position, orientation] covariance growth over ``dt`` seconds."""
    dt = max(float(dt), 1e-4)
    rot_var = GYRO_NOISE_DENSITY**2 * dt + GYRO_BIAS_VAR * dt * dt
    pos_var = 2.0 * VIS_POS_SIGMA**2 + ACCEL_NOISE_DENSITY**2 * dt**3
    return np.diag([pos_var] * 3 + [rot_var] * 3)
