"""IMU preintegration (Forster-style): tensors, and numpy twins for the host.

Port of :mod:`thor_slam_tpu.engine.imu`, which imports JAX at its top and
so cannot be imported where the port runs. Samples between two frames are
integrated over a fixed-size, mask-padded window into the relative motion
increments (delta_r, delta_v, delta_p) that seed the tracker's pose
prediction.

* :func:`preintegrate` / :func:`predict_pose` work on tensors on any
  device (a sequential loop over the window's samples).
* :func:`preintegrate_np`, :func:`preintegrate_fast_np`,
  :func:`gyro_delta_r_np` and :func:`pack_imu_window` are the host twins
  the engine's per-tick prediction uses: a window holds at most 64
  samples of scalar math, cheaper on the host than any device launch.

Conventions: body-frame measurements; the accelerometer measures specific
force (a_body - R^T g); gravity is ``GRAVITY_W`` (z-up world).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from thor_slam_tpu import geometry
from thor_slam_tpu_torch.ops import lie

GRAVITY_W = np.asarray([0.0, 0.0, -9.81])

#: Default noise parameters: the measured OAK-D Pro values of the
#: reference's launch file.
GYRO_NOISE_DENSITY = 8.272e-5  # rad/s/sqrt(Hz)
ACCEL_NOISE_DENSITY = 2.553e-3  # m/s^2/sqrt(Hz)
GYRO_RANDOM_WALK = 1e-8  # rad/s^2/sqrt(Hz)
ACCEL_RANDOM_WALK = 1.0493e-4  # m/s^3/sqrt(Hz)


class Preintegrated(NamedTuple):
    """Relative motion integrated over a window of IMU samples.

    With body frame b0 at the window start and b1 at its end: ``delta_r``
    maps b1 vectors into b0 (R_{b0 b1}); ``delta_v``/``delta_p`` are the
    gravity-free velocity/position increments expressed in b0; ``dt`` the
    integrated time and ``count`` the number of samples integrated.
    Tensors from :func:`preintegrate`, numpy from the host twins.
    """

    delta_r: torch.Tensor | np.ndarray
    delta_v: torch.Tensor | np.ndarray
    delta_p: torch.Tensor | np.ndarray
    dt: torch.Tensor | float
    count: torch.Tensor | int


def preintegrate(
    gyro: torch.Tensor,
    accel: torch.Tensor,
    dts: torch.Tensor,
    mask: torch.Tensor,
    gyro_bias: torch.Tensor | None = None,
    accel_bias: torch.Tensor | None = None,
) -> Preintegrated:
    """Integrate a masked window of IMU samples.

    Args:
        gyro: (N, 3) angular rates (rad/s), body frame.
        accel: (N, 3) specific force (m/s^2), body frame.
        dts: (N,) per-sample integration intervals (s).
        mask: (N,) 1.0/0.0; padding slots contribute nothing.
        gyro_bias, accel_bias: Optional (3,) bias estimates.
    """
    dtype, dev = gyro.dtype, gyro.device
    bg = torch.zeros(3, dtype=dtype, device=dev) if gyro_bias is None else gyro_bias
    ba = torch.zeros(3, dtype=dtype, device=dev) if accel_bias is None else accel_bias
    r = torch.eye(3, dtype=dtype, device=dev)
    v = torch.zeros(3, dtype=dtype, device=dev)
    p = torch.zeros(3, dtype=dtype, device=dev)
    t = torch.zeros((), dtype=dtype, device=dev)
    for w, a, dt in zip(gyro, accel, dts * mask):
        # Euler with the current orientation: at 200-400 Hz the midpoint
        # correction is negligible.
        acc0 = r @ (a - ba)
        p = p + v * dt + 0.5 * acc0 * dt * dt
        v = v + acc0 * dt
        r = r @ lie.so3_exp((w - bg) * dt)
        t = t + dt
    return Preintegrated(delta_r=r, delta_v=v, delta_p=p, dt=t, count=mask.sum().to(torch.int32))


def predict_pose(
    world_t_body: torch.Tensor, velocity_w: torch.Tensor, pre: Preintegrated
) -> tuple[torch.Tensor, torch.Tensor]:
    """Propagate a world pose and velocity through a preintegrated increment.

    Returns (world_t_body at the window end, velocity_w at the window end).
    """
    g = torch.as_tensor(GRAVITY_W, dtype=world_t_body.dtype, device=world_t_body.device)
    r0 = world_t_body[:3, :3]
    p0 = world_t_body[:3, 3]
    dt = pre.dt
    p1 = p0 + velocity_w * dt + 0.5 * g * dt * dt + r0 @ pre.delta_p
    v1 = velocity_w + g * dt + r0 @ pre.delta_v
    return lie.from_rt(r0 @ pre.delta_r, p1[:, None]), v1


# ------------------------------------------------------------- host twins


def preintegrate_np(gyro, accel, dts, mask, gyro_bias=None, accel_bias=None) -> Preintegrated:
    """Numpy twin of :func:`preintegrate`, one sample at a time."""
    bg = np.zeros(3) if gyro_bias is None else np.asarray(gyro_bias)
    ba = np.zeros(3) if accel_bias is None else np.asarray(accel_bias)
    r = np.eye(3)
    v = np.zeros(3)
    p = np.zeros(3)
    t = 0.0
    for w, a, dt, m in zip(np.asarray(gyro), np.asarray(accel), np.asarray(dts), np.asarray(mask)):
        dt = float(dt) * float(m)
        if dt == 0.0:
            continue
        acc0 = r @ (a - ba)
        p = p + v * dt + 0.5 * acc0 * dt * dt
        v = v + acc0 * dt
        phi = (w - bg) * dt
        angle = float(np.linalg.norm(phi))
        if angle > 0:
            r = r @ geometry.quat_to_matrix(geometry.axis_angle_to_quat(phi, angle))
        t += dt
    return Preintegrated(delta_r=r, delta_v=v, delta_p=p, dt=t, count=int(np.sum(mask)))


def _quats_to_matrices(q: np.ndarray) -> np.ndarray:
    """Batched xyzw quaternion -> rotation matrix ((N, 4) -> (N, 3, 3))."""
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    out = np.empty((len(q), 3, 3), np.float64)
    out[:, 0, 0] = 1 - 2 * (y * y + z * z)
    out[:, 0, 1] = 2 * (x * y - z * w)
    out[:, 0, 2] = 2 * (x * z + y * w)
    out[:, 1, 0] = 2 * (x * y + z * w)
    out[:, 1, 1] = 1 - 2 * (x * x + z * z)
    out[:, 1, 2] = 2 * (y * z - x * w)
    out[:, 2, 0] = 2 * (x * z - y * w)
    out[:, 2, 1] = 2 * (y * z + x * w)
    out[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return out


def _hamilton_fold(qs) -> tuple[float, float, float, float]:
    """q <- q * q_i over the rows of ``qs`` (xyzw), on plain floats."""
    x, y, z, w = 0.0, 0.0, 0.0, 1.0
    for qx, qy, qz, qw in qs:
        x, y, z, w = (
            w * qx + x * qw + y * qz - z * qy,
            w * qy - x * qz + y * qw + z * qx,
            w * qz + x * qy - y * qx + z * qw,
            w * qw - x * qx - y * qy - z * qz,
        )
        yield x, y, z, w


def preintegrate_fast_np(gyro, accel, dts, mask, gyro_bias=None, accel_bias=None) -> Preintegrated:
    """Vectorized host twin of :func:`preintegrate` with full increments.

    The axis-angle -> quaternion map, the world-frame accel rotation and the
    velocity/position sums are vectorized over the window; only the
    sequential quaternion fold runs per sample.
    """
    g = np.asarray(gyro, np.float64).reshape(-1, 3)
    a = np.asarray(accel, np.float64).reshape(-1, 3)
    m = np.asarray(mask, np.float64)
    d = np.asarray(dts, np.float64) * m
    if gyro_bias is not None:
        g = g - np.asarray(gyro_bias, np.float64)
    if accel_bias is not None:
        a = a - np.asarray(accel_bias, np.float64)
    n = len(d)
    phi = g * d[:, None]
    angles = np.sqrt(np.einsum("ij,ij->i", phi, phi))
    half = 0.5 * angles
    safe = np.where(angles > 0.0, angles, 1.0)
    k = np.where(angles > 0.0, np.sin(half) / safe, 0.5)  # -> 0.5 as angle -> 0
    qs = np.concatenate([phi * k[:, None], np.cos(half)[:, None]], 1)
    # cum[i] = R(b0 -> frame before sample i).
    cum = np.empty((n + 1, 4))
    cum[0] = (0.0, 0.0, 0.0, 1.0)
    for i, q in enumerate(_hamilton_fold(qs.tolist())):
        cum[i + 1] = q
    r_before = _quats_to_matrices(cum[:-1])
    acc0 = np.einsum("nij,nj->ni", r_before, a) * (d[:, None] > 0.0)
    dv = acc0 * d[:, None]
    v_before = np.concatenate([np.zeros((1, 3)), np.cumsum(dv, 0)[:-1]], 0)
    delta_p = np.sum(v_before * d[:, None] + 0.5 * acc0 * d[:, None] ** 2, 0)
    return Preintegrated(
        delta_r=geometry.quat_to_matrix(cum[-1]),
        delta_v=dv.sum(0),
        delta_p=delta_p,
        dt=float(d.sum()),
        count=int(m.sum()),
    )


def gyro_delta_r_np(gyro, dts, mask, gyro_bias=None) -> np.ndarray:
    """Rotation-only host preintegration: vectorized map + scalar fold.

    Matches :func:`preintegrate_np`'s ``delta_r`` to f64 round-off (same
    right-composition order r <- r @ R(q_i)).
    """
    g = np.asarray(gyro, np.float64).reshape(-1, 3)
    d = np.asarray(dts, np.float64) * np.asarray(mask, np.float64)
    if gyro_bias is not None:
        g = g - np.asarray(gyro_bias, np.float64)
    phi = g * d[:, None]
    angles = np.sqrt(np.einsum("ij,ij->i", phi, phi))
    sel = angles > 0.0
    if not np.any(sel):
        return np.eye(3)
    half = 0.5 * angles[sel]
    k = np.sin(half) / angles[sel]
    qs = np.concatenate([phi[sel] * k[:, None], np.cos(half)[:, None]], 1)
    q = (0.0, 0.0, 0.0, 1.0)
    for q in _hamilton_fold(qs.tolist()):
        pass
    return geometry.quat_to_matrix(np.array(q))


def pack_imu_window(samples_ts, gyros, accels, t_start: float, t_end: float, capacity: int):
    """Pack the raw samples in (t_start, t_end] into fixed arrays.

    Returns (gyro (cap, 3), accel (cap, 3), dts (cap,), mask (cap,)) float32
    numpy arrays; the newest ``capacity`` samples are kept.
    """
    ts = np.asarray(samples_ts, dtype=np.float64)
    gy = np.asarray(gyros, dtype=np.float32).reshape(-1, 3)
    ac = np.asarray(accels, dtype=np.float32).reshape(-1, 3)
    sel = (ts > t_start) & (ts <= t_end)
    ts_s, gy_s, ac_s = ts[sel], gy[sel], ac[sel]
    n = min(len(ts_s), capacity)

    g = np.zeros((capacity, 3), np.float32)
    a = np.zeros((capacity, 3), np.float32)
    d = np.zeros(capacity, np.float32)
    m = np.zeros(capacity, np.float32)
    if n:
        g[:n] = gy_s[-n:]
        a[:n] = ac_s[-n:]
        tsel = ts_s[-n:]
        prev = np.concatenate([[t_start], tsel[:-1]])
        d[:n] = (tsel - prev).astype(np.float32)
        m[:n] = 1.0
    return g, a, d, m
