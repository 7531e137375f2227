"""Ground truth of the synthetic rig: the orbit's body poses and IMU samples.

Plain PyTorch, written from the rig's published geometry (the configuration
file's ``rig`` block), in any dtype: float64 for the reference, a lower
precision for the correctness control. It imports nothing of the program.

The rig body is FLU (+x forward, +y left, +z up) in a z-up world. It
orbits the room's centre at ``radius`` and ``angular_rate``; its yaw
follows the orbit's tangent, and height, roll and pitch oscillate:

    a(t)   = angular_rate * t
    p(t)   = (r cos a, r sin a, height + height_amplitude sin(height_rate t))
    R(t)   = Rz(a + pi/2) Ry(rp_amplitude cos(0.8 rp_rate t)) Rx(rp_amplitude sin(rp_rate t))

The replay sweeps the rig back and forth over an arc of the orbit: at
camera time s the orbit time is

    tau(s) = offset + (T / 4) (1 - cos(2 pi s / T))

for a cycle of T seconds, so the rig covers T / 2 seconds of orbit each
way and slows to a stop at both ends (a palindrome of frames would reverse
its velocity at once, which no rig does and no IMU can report). The IMU
(in the body frame) reads the angular velocity and the specific force
(acceleration minus gravity) of the swept motion, both by central
differences of the pose in camera time over 0.1 ms.
"""

from __future__ import annotations

import math

import numpy as np
import torch

GRAVITY_W = (0.0, 0.0, -9.81)

#: FLU body -> RDF optical frame (columns: the optical axes in body axes).
BODY_T_OPTICAL = np.array(
    [[0.0, 0.0, 1.0, 0.0], [-1.0, 0.0, 0.0, 0.0], [0.0, -1.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]]
)


def _rot(axis: int, a: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) rotations by angles ``a`` about a fixed axis."""
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    if axis == 0:
        rows = [[one, zero, zero], [zero, c, -s], [zero, s, c]]
    elif axis == 1:
        rows = [[c, zero, s], [zero, one, zero], [-s, zero, c]]
    else:
        rows = [[c, -s, zero], [s, c, zero], [zero, zero, one]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def body_poses(orbit: dict, times, dtype=torch.float64) -> torch.Tensor:
    """(N, 4, 4) world_T_body at ``times`` (seconds), computed in ``dtype``."""
    t = times.to(dtype) if isinstance(times, torch.Tensor) else torch.as_tensor(np.asarray(times, np.float64)).to(dtype)
    a = orbit["angular_rate"] * t
    pos = torch.stack(
        [
            orbit["radius"] * torch.cos(a),
            orbit["radius"] * torch.sin(a),
            orbit["height"] + orbit["height_amplitude"] * torch.sin(orbit["height_rate"] * t),
        ],
        -1,
    )
    roll = orbit["rp_amplitude"] * torch.sin(orbit["rp_rate"] * t)
    pitch = orbit["rp_amplitude"] * torch.cos(orbit["rp_rate"] * t * 0.8)
    r = _rot(2, a + math.pi / 2.0) @ _rot(1, pitch) @ _rot(0, roll)
    out = torch.zeros((t.shape[0], 4, 4), dtype=dtype)
    out[:, :3, :3] = r
    out[:, :3, 3] = pos
    out[:, 3, 3] = 1.0
    return out


def sweep_time(s, offset: float, cycle_s: float):
    """Orbit time at camera time ``s`` (seconds; array or tensor) of a sweep
    with a cycle of ``cycle_s`` seconds starting at orbit time ``offset``."""
    lib = torch if isinstance(s, torch.Tensor) else np
    return offset + 0.25 * cycle_s * (1.0 - lib.cos((2.0 * math.pi / cycle_s) * s))


def imu_samples(orbit: dict, times, dt: float = 1e-4, offset: float | None = None, cycle_s: float | None = None):
    """(gyro, accel), each (N, 3) float64 in the body frame at ``times``:
    orbit times, or camera times of a sweep when ``cycle_s`` is given."""
    t = np.asarray(times, np.float64)

    def at(x):
        return body_poses(orbit, x if cycle_s is None else sweep_time(x, offset, cycle_s)).numpy()

    m0, m1, m2 = (at(t + k * dt) for k in (-1.0, 0.0, 1.0))
    r1 = m1[:, :3, :3]
    omega = np.transpose(r1, (0, 2, 1)) @ ((m2[:, :3, :3] - m0[:, :3, :3]) / (2.0 * dt))
    gyro = np.stack([omega[:, 2, 1], omega[:, 0, 2], omega[:, 1, 0]], -1)
    acc_w = (m2[:, :3, 3] - 2.0 * m1[:, :3, 3] + m0[:, :3, 3]) / (dt * dt)
    accel = np.einsum("nji,nj->ni", r1, acc_w - np.asarray(GRAVITY_W))
    return gyro, accel


def mount(yaw: float, offset_m: float) -> np.ndarray:
    """rig_T_source of a source mounted at ``yaw``, ``offset_m`` from the body's axis."""
    c, s = math.cos(yaw), math.sin(yaw)
    m = np.eye(4)
    m[:3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
    m[:3, 3] = [offset_m * c, offset_m * s, 0.0]
    return m


def pinhole(width: int, height: int, focal_scale: float) -> np.ndarray:
    """The rig's 3x3 camera matrix: f = focal_scale * width, centred."""
    f = focal_scale * width
    return np.array([[f, 0.0, width / 2.0], [0.0, f, height / 2.0], [0.0, 0.0, 1.0]])


def pose_errors(est: np.ndarray, gt: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """Per-pose translation error (m) and rotation error (rad) of (N, 4, 4)
    estimates against (N, 4, 4) ground truth, compared in float64. The
    rotation error is |R_gt^T R_est - I|_F / sqrt(2): 2 sin(angle / 2) for
    a rotation, and it also sees a matrix that is no rotation."""
    est64 = np.asarray(est, np.float64)
    gt64 = gt.to(torch.float64).numpy()
    trans = np.linalg.norm(est64[:, :3, 3] - gt64[:, :3, 3], axis=-1)
    rel = np.transpose(gt64[:, :3, :3], (0, 2, 1)) @ est64[:, :3, :3]
    return trans, np.linalg.norm(rel - np.eye(3), axis=(1, 2)) / np.sqrt(2.0)
