"""Host-side pose math: rotations, quaternions, slerp, pose normalization,
RANSAC point-of-interest estimation, and camera-path generators.

These run once at dataset-load / task-setup time (never inside a jitted step),
so plain NumPy is the right tool — no TPU involvement. The reference spread
this across ``src/UtilsCV.py`` using tensorflow-graphics + numpy-quaternion;
here it is ~self-contained NumPy (quaternions are 4-vectors ``[w, x, y, z]``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

X_UNIT = np.array([1.0, 0.0, 0.0])
Y_UNIT = np.array([0.0, 1.0, 0.0])


# --------------------------------------------------------------------------- #
# Elementary rotations and the "sphere" camera placement.                     #
# --------------------------------------------------------------------------- #

def rot_x(deg: float) -> np.ndarray:
    """4x4 rotation about x (reference ``src/UtilsCV.py:53-66``)."""
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    m = np.eye(4)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def rot_y(deg: float) -> np.ndarray:
    """4x4 rotation about y. Note the reference's sign convention
    (``src/UtilsCV.py:85-98``): ``[[c, 0, -s], [0, 1, 0], [s, 0, c]]``."""
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    m = np.eye(4)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, -s, s, c
    return m


def rot_z(deg: float) -> np.ndarray:
    """4x4 rotation about z (reference ``src/UtilsCV.py:69-82``)."""
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    m = np.eye(4)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def sphere_c2w(radius: float, x_deg: float, y_deg: float, z_deg: float) -> np.ndarray:
    """Camera on a sphere of ``radius`` looking at the origin:
    ``Rz @ Ry @ Rx @ T(z=radius)`` (reference ``src/UtilsCV.py:101-121``)."""
    t = np.eye(4)
    t[2, 3] = radius
    return rot_z(z_deg) @ rot_y(y_deg) @ rot_x(x_deg) @ t


# --------------------------------------------------------------------------- #
# Quaternions ([w, x, y, z]) and slerp.                                       #
# --------------------------------------------------------------------------- #

def normalize(v: np.ndarray) -> np.ndarray:
    """L2-normalize along the last axis (reference ``src/UtilsCV.py:250-256``)."""
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def quat_from_rotation_matrix(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion [w, x, y, z] (Shepperd's method)."""
    m = np.asarray(m, dtype=np.float64)
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    return np.array([w, x, y, z])


def quat_to_rotation_matrix(q: np.ndarray) -> np.ndarray:
    """Unit quaternion [w, x, y, z] -> 3x3 rotation matrix."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def quat_multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamilton product of quaternions [w, x, y, z]."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def quat_conjugate(q: np.ndarray) -> np.ndarray:
    return np.array([q[0], -q[1], -q[2], -q[3]])


def quat_from_axis_angle(axis: np.ndarray, theta: float) -> np.ndarray:
    """Rotation of ``theta`` radians about unit ``axis``
    (reference ``src/UtilsCV.py:612-623``)."""
    return np.concatenate([[np.cos(theta / 2)], axis * np.sin(theta / 2)])


def quat_between_vectors(v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """Quaternion rotating ``v1`` onto ``v2`` with the reference's degenerate-
    case handling (anti-parallel and parallel branches,
    ``src/UtilsCV.py:626-656``)."""
    a = normalize(v1)
    b = normalize(v2)
    d = float(a.dot(b))
    if d < -0.99999:
        axis = np.cross(X_UNIT, a)
        if np.linalg.norm(axis) < 1e-5:
            axis = np.cross(Y_UNIT, a)
        return quat_from_axis_angle(normalize(axis), np.pi)
    if d > 0.99999:
        return np.array([1.0, 0.0, 0.0, 0.0])
    axis = normalize(np.cross(a, b))
    return quat_from_axis_angle(axis, np.arccos(d))


def rotate_vector(v: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Rotate 3-vector ``v`` by quaternion ``q`` via ``q * v * q^-1``
    (reference ``src/UtilsCV.py:659-669``)."""
    vq = np.concatenate([[0.0], v])
    return quat_multiply(quat_multiply(q, vq), quat_conjugate(q))[1:]


def rotation_matrix_between_vectors(v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """3x3 rotation taking ``v1`` to ``v2`` (reference ``src/UtilsCV.py:672-680``)."""
    return quat_to_rotation_matrix(quat_between_vectors(v1, v2))


def rotation_matrix_source_to_dest(source: np.ndarray, dest: np.ndarray) -> np.ndarray:
    """4x4 rotation R with ``R @ source == dest`` (rotation parts), via
    ``q_rot = q_dest * q_source^-1`` (reference ``src/UtilsCV.py:683-697``)."""
    q = quat_multiply(
        quat_from_rotation_matrix(dest), quat_conjugate(quat_from_rotation_matrix(source))
    )
    out = np.eye(4)
    out[:3, :3] = quat_to_rotation_matrix(q)
    return out


def slerp_quat(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    """Spherical linear interpolation with shortest-path sign flip
    (reference ``src/UtilsCV.py:208-226``)."""
    cos_a = float(np.dot(q0, q1))
    if cos_a < 0:
        q1, cos_a = -q1, -cos_a
    if cos_a > 1.0 - 1e-9:
        # Nearly identical: fall back to (normalized) lerp to avoid 0/0.
        return normalize(q0 * (1.0 - t) + q1 * t)
    omega = np.arccos(cos_a)
    so = np.sin(omega)
    return np.sin((1.0 - t) * omega) / so * q0 + np.sin(t * omega) / so * q1


def interpolate_c2w(c2w1: np.ndarray, c2w2: np.ndarray, alpha) -> np.ndarray:
    """Slerp the rotations, lerp the translations of two c2w matrices.

    ``alpha`` may be a scalar or an array; the result matches in leading shape
    (reference ``src/UtilsCV.py:175-205``, sans the tensorflow-graphics
    dependency).

    :return: ``(4, 4)`` for scalar alpha, else ``(len(alpha), 4, 4)``.
    """
    c2w1 = np.asarray(c2w1, np.float64)
    c2w2 = np.asarray(c2w2, np.float64)
    q1 = quat_from_rotation_matrix(c2w1[:3, :3])
    q2 = quat_from_rotation_matrix(c2w2[:3, :3])
    t1, t2 = c2w1[:3, 3], c2w2[:3, 3]

    def one(a: float) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = quat_to_rotation_matrix(slerp_quat(q1, q2, a))
        m[:3, 3] = t1 * (1 - a) + t2 * a
        return m

    alpha = np.asarray(alpha, dtype=np.float64)
    if alpha.ndim == 0:
        return one(float(alpha))
    return np.stack([one(float(a)) for a in alpha])


def c2w_path_between(c2w1, c2w2, n_renders: int = 16) -> np.ndarray:
    """Evenly-spaced slerp path between two poses
    (reference ``src/UtilsCV.py:146-158``)."""
    return interpolate_c2w(c2w1, c2w2, np.linspace(0, 1, n_renders))


def c2w_path_between_with_stretch(c2w1, c2w2, n_renders: int, stretch_knob: float = 1.0) -> np.ndarray:
    """Slerp path whose parameterization slows down approaching ``c2w2``
    (reference ``src/UtilsCV.py:229-247``)."""
    alpha = np.linspace(0, 1, n_renders)
    stretched = alpha / (alpha + 1 + stretch_knob)
    stretched = (stretched - stretched.min()) / (stretched.max() - stretched.min())
    return interpolate_c2w(c2w1, c2w2, stretched)


# --------------------------------------------------------------------------- #
# Pose-set normalization (dataset load path).                                 #
# --------------------------------------------------------------------------- #

def to_homogeneous(mats: np.ndarray) -> np.ndarray:
    """Append a ``[0, 0, 0, 1]`` row to a batch of 3x4 matrices
    (reference ``src/UtilsCV.py:300-307``)."""
    bottom = np.broadcast_to(np.array([0.0, 0.0, 0.0, 1.0]), (mats.shape[0], 1, 4))
    return np.concatenate([mats, bottom], axis=1)


def orthonormal_basis_from(z: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Right-handed basis with third column along ``z``, second near ``y``
    (reference ``src/UtilsCV.py:259-271``; columns are [x, y, z])."""
    v2 = normalize(z)
    v0 = normalize(np.cross(y, v2))
    v1 = normalize(np.cross(v2, v0))
    return np.stack([v0, v1, v2], axis=1)


def poses_average(poses: np.ndarray) -> np.ndarray:
    """Mean camera pose: mean translation, basis from mean z/y columns
    (reference ``src/UtilsCV.py:274-283``). Returns 3x4."""
    t = poses[:, :3, 3].mean(0)
    z = poses[:, :3, 2].mean(0)
    y = poses[:, :3, 1].mean(0)
    return np.concatenate([orthonormal_basis_from(z, y), t[:, None]], axis=1)


def recenter_poses(poses: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Re-express all poses in the average-camera frame.

    Operates on ``(N, 3+, >=4)`` pose arrays (extra hwf columns pass through
    untouched, matching the reference's in-place column update,
    ``src/UtilsCV.py:286-297``).

    :return: ``(recentered poses (copy), average c2w before recentering (4x4))``.
    """
    poses = np.array(poses)  # copy; reference mutates in place
    avg = to_homogeneous(poses_average(poses[:, :3, :4])[None])[0]
    homog = to_homogeneous(poses[:, :3, :4])
    poses[:, :3, :4] = (np.linalg.inv(avg) @ homog)[:, :3, :]
    return poses, avg


def spherify_poses(poses: np.ndarray, bounds: np.ndarray) -> Tuple[np.ndarray, np.ndarray, float]:
    """Scale camera positions into the unit sphere; scale bounds identically
    (reference ``src/UtilsCV.py:320-330``).

    :return: ``(scaled poses (copy), scaled bounds, scale factor)``.
    """
    poses = np.array(poses)
    radius = np.sqrt(np.max(np.sum(np.square(poses[:, :3, 3]), axis=-1)))
    scale = 1.0 / radius
    poses[:, :3, 3] *= scale
    return poses, np.asarray(bounds) * scale, scale


def camera_direction(c2w: np.ndarray) -> np.ndarray:
    """Unit viewing direction of a camera: ``-z`` column
    (reference ``src/UtilsCV.py:602-609``)."""
    return normalize(-np.asarray(c2w)[:3, 2])


# --------------------------------------------------------------------------- #
# Scene point-of-interest (RANSAC over camera viewing lines).                 #
# --------------------------------------------------------------------------- #

def intersect_lines_least_squares(dirs_and_points: np.ndarray) -> Optional[np.ndarray]:
    """Least-squares 3D point minimizing distance to all lines
    (reference ``src/UtilsCV.py:333-355``; the standard projector formulation).

    :param dirs_and_points: ``(N, 2, 3)`` — per line a (direction, point) pair.
    :return: ``(3,)`` point, or ``None`` for a single line.
    """
    if dirs_and_points.shape[0] == 1:
        return None
    dirs = normalize(dirs_and_points[:, 0])
    pts = dirs_and_points[:, 1]
    eye = np.eye(3)
    projectors = eye - dirs[:, :, None] * dirs[:, None, :]  # (N, 3, 3)
    a = projectors.reshape(-1, 3)
    b = (projectors @ pts[..., None]).reshape(-1)
    return np.linalg.lstsq(a, b, rcond=None)[0]


def point_to_lines_distance(point: np.ndarray, dirs_and_points: np.ndarray) -> np.ndarray:
    """Squared projector-form distances from ``point`` to each line
    (reference ``src/UtilsCV.py:358-375``)."""
    dirs = normalize(dirs_and_points[:, 0])
    pts = dirs_and_points[:, 1]
    projectors = np.eye(3) - dirs[:, :, None] * dirs[:, None, :]
    diff = pts - point
    return np.squeeze(diff[:, None, :] @ projectors @ diff[:, :, None])


def ransac_line_intersection(
    dirs_and_points: np.ndarray,
    num_iter: int = 10_000,
    inlier_tol: float = 1e-3,
    n_lines: int = 2,
    rng: Optional[np.random.Generator] = None,
):
    """RANSAC consensus estimate of the mutual intersection of many lines
    (reference ``src/UtilsCV.py:378-404``). Vectorized over iterations:
    all minimal-set intersections are solved in one batched 6x3 lstsq sweep.

    :return: ``(point, inlier indices)`` or ``(None, None)``.
    """
    rng = rng or np.random.default_rng(0)
    n = dirs_and_points.shape[0]

    # Draw all minimal sets up front (vectorized choice without replacement).
    picks = np.argsort(rng.random((num_iter, n)), axis=1)[:, :n_lines]

    # All minimal-set intersections in one batched sweep via the normal
    # equations: x = pinv(sum_i P_i) @ (sum_i P_i p_i) with the projectors
    # P_i = I - d_i d_i^T. For the (6, 3) per-set system this is identical to
    # np.linalg.lstsq's min-norm solution (pinv(A^T A) A^T = pinv(A)), and
    # batched pinv stays robust to parallel-line (rank-deficient) draws.
    dirs = normalize(dirs_and_points[:, 0])
    pts = dirs_and_points[:, 1]
    projectors = np.eye(3) - dirs[:, :, None] * dirs[:, None, :]   # (n, 3, 3)
    proj_pts = (projectors @ pts[..., None])[..., 0]               # (n, 3)
    A = projectors[picks].sum(axis=1)                              # (iters, 3, 3)
    b = proj_pts[picks].sum(axis=1)                                # (iters, 3)
    # Closed-form 3x3 inverse (adjugate/det) for the well-posed draws; the
    # rare near-parallel (rank-deficient) draws fall back to batched pinv.
    adj = np.empty_like(A)
    adj[:, 0] = np.cross(A[:, :, 1], A[:, :, 2], axis=1)
    adj[:, 1] = np.cross(A[:, :, 2], A[:, :, 0], axis=1)
    adj[:, 2] = np.cross(A[:, :, 0], A[:, :, 1], axis=1)
    det = np.einsum("ij,ij->i", A[:, :, 0], adj[:, 0])
    ok = np.abs(det) > 1e-9
    points = np.empty((A.shape[0], 3), A.dtype)
    points[ok] = (
        np.einsum("nij,nj->ni", adj[ok], b[ok]) / det[ok, None]
    )
    if not ok.all():
        points[~ok] = (np.linalg.pinv(A[~ok]) @ b[~ok, :, None])[..., 0]

    # Squared projector-form distance of every candidate to every line.
    diff = pts[None, :, :] - points[:, None, :]                    # (iters, n, 3)
    d2 = np.einsum("inj,njk,ink->in", diff, projectors, diff)
    counts = (d2 < inlier_tol).sum(axis=1)
    best = int(np.argmax(counts))  # first maximum == the sequential loop's pick
    best_count = int(counts[best])
    best_inliers = np.where(d2[best] < inlier_tol)[0]
    if best_count > 1:
        point = intersect_lines_least_squares(dirs_and_points[best_inliers])
        d = point_to_lines_distance(point, dirs_and_points)
        return point, np.where(d < inlier_tol)[0]
    return None, None


def estimate_point_of_interest(c2w_matrices, **ransac_kwargs):
    """Estimate where the cameras jointly look; classify the scene spherical
    when >30% of views are inliers (reference ``src/UtilsCV.py:440-464``).

    :return: ``(point or None, is_spherical_scene)``.
    """
    c2w_matrices = np.asarray(c2w_matrices)
    assert len(c2w_matrices) > 1
    lines = np.stack(
        [
            np.stack([camera_direction(c2w), c2w[:3, 3]], axis=0)
            for c2w in c2w_matrices
        ]
    )
    point, inliers = ransac_line_intersection(lines, **ransac_kwargs)
    if point is None or inliers is None:
        return None, False
    return point, inliers.shape[0] > 0.3 * lines.shape[0]


# --------------------------------------------------------------------------- #
# Camera-path generators for the video tasks.                                 #
# --------------------------------------------------------------------------- #

def l_to_r_c2w_matrices(total_frames: int) -> np.ndarray:
    """Identity-rotation poses translating x across [-1, 1]
    (reference ``src/UtilsCV.py:407-425``)."""
    mats = np.tile(np.eye(4, dtype=np.float32), (total_frames, 1, 1))
    mats[:, 0, 3] = np.linspace(0, 1, total_frames) * 2 - 1
    return mats


def sphere_orbit_c2w_matrices(total_frames: int) -> np.ndarray:
    """A y-axis orbit followed by an x-axis orbit at unit radius
    (reference ``src/UtilsCV.py:428-437``)."""
    ys = [sphere_c2w(1, 0, d, 0) for d in np.linspace(0, 360, total_frames)]
    xs = [sphere_c2w(1, d, 0, 0) for d in np.linspace(0, 360, total_frames)]
    return np.asarray(ys + xs, dtype=np.float32)


def multi_waypoint_path(c2ws: np.ndarray, frames_per_leg: int, stretch_knob: float = 1.0) -> np.ndarray:
    """Closed tour through the waypoints with slow-down easing per leg
    (reference ``src/ExecutionRun.py:425-440``)."""
    legs: List[np.ndarray] = []
    for a, b in zip(c2ws[:-1], c2ws[1:]):
        legs.append(c2w_path_between_with_stretch(a, b, frames_per_leg, stretch_knob))
    legs.append(c2w_path_between_with_stretch(c2ws[-1], c2ws[0], frames_per_leg, stretch_knob))
    return np.concatenate(legs, axis=0)


def euler_degrees_from_matrix(m: np.ndarray):
    """Euler xyz angles (degrees) of a rotation matrix
    (reference ``src/UtilsCV.py:41-50``)."""
    m = np.asarray(m)
    x = np.rad2deg(np.arctan2(m[..., 2, 1], m[..., 2, 2]))
    y = np.rad2deg(
        np.arctan2(-m[..., 2, 0], np.sqrt(m[..., 2, 1] ** 2 + m[..., 2, 2] ** 2))
    )
    z = np.rad2deg(np.arctan2(m[..., 1, 0], m[..., 0, 0]))
    return x, y, z
