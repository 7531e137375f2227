"""Host-side rigid-body geometry: quaternions, SE(3), frame conventions.

All quaternions follow the ``[qx, qy, qz, qw]`` (scalar-last) convention used
throughout the public API (reference: thor_slam/slam/interface.py:43).

Frame conventions (reference: thor_slam/slam/adapters/isaac_ros.py:33-49 and
scripts/run_slam.py:254-276 — the scripts are the behavior spec):

* ``RDF``  — camera optical frame: +x right, +y down, +z forward (Luxonis).
* ``FLU``  — robot base frame: +x forward, +y left, +z up (ROS / Isaac).
* ``DRB``  — OAK-D Pro IMU frame: +x down, +y right, +z back.

This module is intentionally NumPy-only: it runs on the host for calibration
plumbing. The device-side Lie-group math lives in
:mod:`thor_slam_tpu_torch.ops.lie`.

Copy of :mod:`thor_slam_tpu.geometry`, kept in the port so that
the port imports nothing of the JAX package; keep the two in step.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Frame-convention change-of-basis matrices (4x4 homogeneous).
# ``FLU_FROM_RDF @ p_rdf`` expresses an RDF-frame point in FLU coordinates.
# ---------------------------------------------------------------------------

#: RDF point -> FLU coordinates: forward = z, left = -x, up = -y.
FLU_FROM_RDF = np.array(
    [
        [0.0, 0.0, 1.0, 0.0],
        [-1.0, 0.0, 0.0, 0.0],
        [0.0, -1.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ]
)

#: FLU point -> RDF coordinates (inverse of FLU_FROM_RDF; orthonormal => transpose).
RDF_FROM_FLU = FLU_FROM_RDF.T.copy()

#: DRB point -> RDF coordinates: right = y_drb, down = x_drb, forward = -z_drb.
RDF_FROM_DRB = np.array(
    [
        [0.0, 1.0, 0.0, 0.0],
        [1.0, 0.0, 0.0, 0.0],
        [0.0, 0.0, -1.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ]
)

# Backwards-compatible aliases matching the reference's naming.
RDF_TO_FLU_MATRIX = FLU_FROM_RDF
DRB_TO_RDF_MATRIX = RDF_FROM_DRB


# ---------------------------------------------------------------------------
# Quaternions (xyzw, scalar-last)
# ---------------------------------------------------------------------------

def quat_identity() -> np.ndarray:
    """Identity quaternion [0, 0, 0, 1]."""
    return np.array([0.0, 0.0, 0.0, 1.0])


def quat_normalize(q: np.ndarray) -> np.ndarray:
    """Return the unit quaternion, keeping qw >= 0 for a canonical sign."""
    q = np.asarray(q, dtype=np.float64)
    n = np.linalg.norm(q)
    if n == 0.0:
        raise ValueError("Cannot normalize a zero quaternion")
    q = q / n
    return -q if q[3] < 0.0 else q


def quat_multiply(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Hamilton product q1 * q2 (both xyzw): rotate by q2 first, then q1."""
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return np.array(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ]
    )


def quat_conjugate(q: np.ndarray) -> np.ndarray:
    """Conjugate (inverse for unit quaternions)."""
    return np.array([-q[0], -q[1], -q[2], q[3]])


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (xyzw) -> 3x3 rotation matrix."""
    x, y, z, w = quat_normalize(q)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return np.array(
        [
            [1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)],
            [2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)],
            [2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)],
        ]
    )


def matrix_to_quat(m: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> unit quaternion (xyzw), Shepperd's method."""
    m = np.asarray(m, dtype=np.float64)
    t = np.trace(m)
    if t > 0.0:
        s = np.sqrt(t + 1.0) * 2.0
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2.0
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2.0
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2.0
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    return quat_normalize(np.array([x, y, z, w]))


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vector(s) v by unit quaternion q."""
    return np.asarray(v) @ quat_to_matrix(q).T


def axis_angle_to_quat(axis: np.ndarray, angle: float) -> np.ndarray:
    """Axis-angle -> quaternion (xyzw). Axis need not be normalized."""
    axis = np.asarray(axis, dtype=np.float64)
    n = np.linalg.norm(axis)
    if n == 0.0:
        return quat_identity()
    half = 0.5 * angle
    return np.concatenate([axis / n * np.sin(half), [np.cos(half)]])


# ---------------------------------------------------------------------------
# Euler angles (URDF rpy = extrinsic XYZ; reference: camera/utils.py:116-119)
# ---------------------------------------------------------------------------

def _rot_x(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def _rot_y(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _rot_z(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def euler_xyz_extrinsic_to_matrix(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """Extrinsic XYZ Euler (URDF ``rpy``) -> 3x3 rotation matrix.

    Extrinsic XYZ means: rotate about the *fixed* X axis by roll, then the
    fixed Y axis by pitch, then the fixed Z axis by yaw, i.e.
    ``R = Rz(yaw) @ Ry(pitch) @ Rx(roll)``.
    """
    return _rot_z(yaw) @ _rot_y(pitch) @ _rot_x(roll)


# ---------------------------------------------------------------------------
# SE(3) helpers on 4x4 homogeneous matrices
# ---------------------------------------------------------------------------

def se3_matrix(rotation: np.ndarray, translation: np.ndarray) -> np.ndarray:
    """Assemble a 4x4 homogeneous transform from R (3x3) and t (3,)."""
    m = np.eye(4)
    m[:3, :3] = rotation
    m[:3, 3] = np.asarray(translation).reshape(3)
    return m


def se3_inverse(m: np.ndarray) -> np.ndarray:
    """Invert a rigid 4x4 transform analytically: (R, t) -> (R^T, -R^T t)."""
    r = m[:3, :3]
    t = m[:3, 3]
    return se3_matrix(r.T, -r.T @ t)


def se3_from_pose(position: np.ndarray, quat_xyzw: np.ndarray) -> np.ndarray:
    """(position, quaternion) -> 4x4 homogeneous transform."""
    return se3_matrix(quat_to_matrix(quat_xyzw), position)


def pose_from_se3(m: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """4x4 homogeneous transform -> (position, quaternion xyzw)."""
    return m[:3, 3].copy(), matrix_to_quat(m[:3, :3])


def rotate_cov6(r: np.ndarray, cov: np.ndarray) -> np.ndarray:
    """Rotate a 6x6 [position(3), orientation(3)] covariance by ``r``.

    Both blocks conjugate with the same 3x3 rotation (block-diagonal
    change of basis); cross-covariance blocks transform consistently.
    """
    rot6 = np.zeros((6, 6))
    rot6[:3, :3] = r
    rot6[3:, 3:] = r
    return rot6 @ np.asarray(cov, np.float64) @ rot6.T
