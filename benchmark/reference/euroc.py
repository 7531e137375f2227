"""The EuRoC MAV sensor head: its published calibration, its lenses, its IMU.

Plain PyTorch and NumPy, written from the dataset's own numbers (Burri et
al., "The EuRoC micro aerial vehicle datasets", IJRR 2016; sequence
MH_01_easy's ``mav0/cam0``, ``mav0/cam1`` and ``mav0/imu0`` ``sensor.yaml``),
importing nothing of the program.

* The VI-sensor pair: two MT9V034 at 752x480, each with its own intrinsics
  and radial-tangential coefficients (k1, k2, p1, p2), posed in the body
  frame by ``T_BS``; the body frame is the IMU's (ADIS16448, 200 Hz).
* :func:`distort` and :func:`undistort` (fixed-point iteration in float64 to
  convergence) are the radial-tangential model on normalized coordinates.
* :func:`render` ray casts the frozen room (:mod:`benchmark.reference.scene`'s
  box and texture) through that model: a raw pixel's ray is its undistorted
  direction, so the pair comes out distorted and unrectified as the
  VI-sensor delivers it. Pixel (u, v) of the raw image sees normalized
  coordinates ((u - cu) / fu, (v - cv) / fv), pixel centres at whole
  coordinates, as the calibration defines them.
* :func:`imu_samples` measures the IMU at its own place and in its own
  axes: the rate, and the specific force with the lever arm's terms, by the
  central differences of :func:`benchmark.reference.orbit.imu_samples`;
  :func:`imu_noise` is white noise at the published densities.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import orbit, scene

#: The published image size of both cameras.
WIDTH, HEIGHT = 752, 480
#: (fu, fv, cu, cv) of cam0 and cam1 at 752x480.
INTRINSICS = ((458.654, 457.296, 367.215, 248.375), (457.587, 456.134, 379.999, 255.238))
#: (k1, k2, p1, p2) of cam0 and cam1.
DISTORTION = (
    (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05),
    (-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05),
)
#: cam0's and cam1's pose in the body (IMU) frame; imu0's is the identity.
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
T_BS_IMU = np.eye(4)
#: ADIS16448 white-noise densities: gyro (rad/s/sqrt(Hz)), accel (m/s^2/sqrt(Hz)).
GYRO_NOISE_DENSITY, ACCEL_NOISE_DENSITY = 1.6968e-4, 2.0e-3
#: Fixed-point iterations of :func:`undistort` (converged to float64 well
#: before: the worst contraction over the 752x480 image is about 0.7).
UNDISTORT_ITERS = 200


def intrinsics(eye: int, width: int = WIDTH, height: int = HEIGHT) -> tuple[float, float, float, float]:
    """(fu, fv, cu, cv) of ``eye`` for images of ``width`` x ``height``
    (the published values scaled with the image)."""
    fu, fv, cu, cv = INTRINSICS[eye]
    sx, sy = width / WIDTH, height / HEIGHT
    return fu * sx, fv * sy, cu * sx, cv * sy


def matrix(eye: int, width: int = WIDTH, height: int = HEIGHT) -> np.ndarray:
    fu, fv, cu, cv = intrinsics(eye, width, height)
    return np.array([[fu, 0.0, cu], [0.0, fv, cv], [0.0, 0.0, 1.0]])


def cam0_t_cam1() -> np.ndarray:
    return np.linalg.inv(T_BS_CAM0) @ T_BS_CAM1


def cam0_t_imu() -> np.ndarray:
    return np.linalg.inv(T_BS_CAM0) @ T_BS_IMU


def distort(xy, coeffs):
    """Radial-tangential distortion of normalized points (..., 2), numpy or torch."""
    k1, k2, p1, p2 = coeffs
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    lib = torch if isinstance(xy, torch.Tensor) else np
    return lib.stack([xd, yd], -1)


def undistort(xy_d, coeffs, iters: int = UNDISTORT_ITERS):
    """The normalized points (..., 2) that :func:`distort` takes to ``xy_d``,
    by fixed-point iteration in float64 (a numpy array, or a float64 tensor
    on its device)."""
    k1, k2, p1, p2 = coeffs
    lib = torch if isinstance(xy_d, torch.Tensor) else np
    xd, yd = (xy_d if lib is torch else np.asarray(xy_d, np.float64))[..., 0], xy_d[..., 1]
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (xd - dx) / radial, (yd - dy) / radial
    return lib.stack([x, y], -1)


def rays(eye: int, width: int = WIDTH, height: int = HEIGHT, device="cpu") -> torch.Tensor:
    """(H, W, 3) float64 camera-frame ray (x, y, 1) of each raw pixel of
    ``eye``, computed on ``device``."""
    fu, fv, cu, cv = intrinsics(eye, width, height)
    vv, uu = torch.meshgrid(torch.arange(height, dtype=torch.float64, device=device),
                            torch.arange(width, dtype=torch.float64, device=device), indexing="ij")
    xy = undistort(torch.stack([(uu - cu) / fu, (vv - cv) / fv], -1), DISTORTION[eye])
    return torch.cat([xy, torch.ones_like(xy[..., :1])], -1)


def render(rig: dict, cam_rays, world_t_cams, device) -> torch.Tensor:
    """(B, H, W) float32 images in [0, 1] of the room from B camera poses,
    each pixel along its ray of ``cam_rays`` ((H, W, 3), z = 1): the ray
    cast, texture and shading of :func:`benchmark.reference.scene.render`."""
    poses = torch.as_tensor(np.asarray(world_t_cams, np.float32)).to(device)
    d = torch.as_tensor(cam_rays).to(device=device, dtype=torch.float32)
    dx, dy = d[..., 0], d[..., 1]
    r = poses[:, :3, :3, None, None]
    origin = poses[:, :3, 3, None, None]
    dirs = dx * r[:, :, 0] + dy * r[:, :, 1] + r[:, :, 2]  # (B, 3, H, W)

    he = torch.tensor(rig["room_half_extents"], dtype=torch.float32, device=device)[None, :, None, None]
    eps = 1e-6
    small = torch.abs(dirs) < eps
    safe = torch.where(small, eps, dirs)
    t_exit = torch.where(small, 1e9, (torch.sign(safe) * he - origin) / safe)
    t_hit = torch.amin(t_exit, dim=1)

    img = scene.texture((origin + dirs * t_hit[:, None]).movedim(1, -1), rig["texture_seed"])
    depth = t_hit * torch.sqrt(dx * dx + dy * dy + 1.0)
    shade = 1.0 / (1.0 + 0.02 * depth)
    return torch.clamp(img * (0.55 + 0.45 * shade) + 0.15, 0.0, 1.0)


def imu_samples(orbit_cfg: dict, times, body_t_imu: np.ndarray, offset: float, cycle_s: float, dt: float = 1e-4):
    """(gyro, accel), each (N, 3) float64, of an IMU at ``body_t_imu`` on the
    orbit's body, in the IMU's axes, at camera ``times`` of a sweep: the
    angular rate, and the specific force (acceleration of the IMU's own
    place minus gravity), by central differences over ``dt``."""
    t = np.asarray(times, np.float64)
    b = np.asarray(body_t_imu, np.float64)

    def at(x):
        return orbit.body_poses(orbit_cfg, orbit.sweep_time(x, offset, cycle_s)).numpy() @ b

    m0, m1, m2 = (at(t + k * dt) for k in (-1.0, 0.0, 1.0))
    r1 = m1[:, :3, :3]
    omega = np.transpose(r1, (0, 2, 1)) @ ((m2[:, :3, :3] - m0[:, :3, :3]) / (2.0 * dt))
    gyro = np.stack([omega[:, 2, 1], omega[:, 0, 2], omega[:, 1, 0]], -1)
    acc_w = (m2[:, :3, 3] - 2.0 * m1[:, :3, 3] + m0[:, :3, 3]) / (dt * dt)
    accel = np.einsum("nji,nj->ni", r1, acc_w - np.asarray(orbit.GRAVITY_W))
    return gyro, accel


def imu_noise(n: int, rate_hz: float, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """(gyro, accel) white noise of ``n`` samples at ``rate_hz``: the
    published densities times sqrt(rate)."""
    s = math.sqrt(rate_hz)
    return (rng.normal(0.0, GYRO_NOISE_DENSITY * s, (n, 3)), rng.normal(0.0, ACCEL_NOISE_DENSITY * s, (n, 3)))
