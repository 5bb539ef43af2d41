"""SE(3) / SO(3) / quaternion math on tensors, batched over leading dims.

Port of ``mageslam_tpu/geometry/se3.py``.  A pose is a flat 7-vector
``[qw, qx, qy, qz, tx, ty, tz]`` for the world-to-camera (view) transform
``x_cam = R(q) @ x_world + t``.  Tangent vectors are ``[omega, upsilon]``
with left-multiplicative updates ``T <- Exp(xi) * T``.  Every formula keeps
the JAX package's order of operations, so results agree to float32
rounding.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], -1)


def quat_identity(device=None, dtype=torch.float32) -> torch.Tensor:
    q = torch.zeros(4, dtype=dtype, device=device)
    q[0] = 1.0
    return q


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    q = q / torch.clamp(n, min=_EPS)
    # canonical sign: w >= 0
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], -1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    qv = q[..., 1:]
    uv = _cross(qv, v)
    uuv = _cross(qv, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], -1)
    return m.reshape(m.shape[:-1] + (3, 3))


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4), branch-free Shepperd's method."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    qw0 = safe_sqrt(1.0 + tr) / 2.0
    c0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], -1)
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    c1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], -1)
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    c2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], -1)
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    c3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], -1)
    pivots = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                          m22 - m00 - m11], -1)
    idx = torch.argmax(pivots, dim=-1)
    cands = torch.stack([c0, c1, c2, c3], -2)
    q = torch.gather(cands, -2, idx[..., None, None].expand(
        idx.shape + (1, 4)))[..., 0, :]
    return quat_normalize(q)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    theta_sq = torch.sum(omega * omega, -1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta_sq, min=0.0))
    half = 0.5 * theta
    small = theta_sq < 1e-10
    k = torch.where(small, 0.5 - theta_sq / 48.0,
                    torch.sin(half) / torch.clamp(theta, min=_EPS))
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return quat_normalize(torch.cat([w, k * omega], -1))


def so3_log(q: torch.Tensor) -> torch.Tensor:
    q = quat_normalize(q)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vn = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(vn, w)
    k = torch.where(vn < 1e-8, 2.0 / torch.clamp(w, min=_EPS),
                    theta / torch.clamp(vn, min=_EPS))
    return k * v


def hat(omega: torch.Tensor) -> torch.Tensor:
    ox, oy, oz = omega.unbind(-1)
    zero = torch.zeros_like(ox)
    m = torch.stack([zero, -oz, oy, oz, zero, -ox, -oy, ox, zero], -1)
    return m.reshape(m.shape[:-1] + (3, 3))


def pose_identity(device=None, dtype=torch.float32) -> torch.Tensor:
    # built on the device (no host-to-device copy, so no stream sync)
    p = torch.zeros(7, dtype=dtype, device=device)
    p[0] = 1.0
    return p


def pose_q(p: torch.Tensor) -> torch.Tensor:
    return p[..., :4]


def pose_t(p: torch.Tensor) -> torch.Tensor:
    return p[..., 4:]


def make_pose(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    q, t = quat_normalize(q), t
    shape = torch.broadcast_shapes(q.shape[:-1], t.shape[:-1])
    return torch.cat([q.expand(shape + (4,)), t.expand(shape + (3,))], -1)


def pose_apply(p: torch.Tensor, x_world: torch.Tensor) -> torch.Tensor:
    return quat_rotate(pose_q(p), x_world) + pose_t(p)


def pose_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    q = quat_mul(pose_q(a), pose_q(b))
    t = quat_rotate(pose_q(a), pose_t(b)) + pose_t(a)
    return make_pose(q, t)


def pose_inverse(p: torch.Tensor) -> torch.Tensor:
    qi = quat_conj(pose_q(p))
    return make_pose(qi, -quat_rotate(qi, pose_t(p)))


def pose_relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """T_ab = a * b^-1 (maps b's camera frame into a's)."""
    return pose_compose(a, pose_inverse(b))


def pose_to_mat44(p: torch.Tensor) -> torch.Tensor:
    R = quat_to_mat(pose_q(p))
    t = pose_t(p)[..., :, None]
    top = torch.cat([R, t], -1)
    bottom = torch.zeros(4, dtype=p.dtype, device=p.device)
    bottom[3] = 1.0
    bottom = bottom.expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], -2)


def mat44_to_pose(m: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) view matrix -> (..., 7) pose."""
    return make_pose(mat_to_quat(m[..., :3, :3]), m[..., :3, 3])


def camera_center(p: torch.Tensor) -> torch.Tensor:
    """World-frame camera position C = -R^T t."""
    return -quat_rotate(quat_conj(pose_q(p)), pose_t(p))


def pose_retract(p: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative update T <- Exp(xi) * T."""
    dq = so3_exp(xi[..., :3])
    q = quat_mul(dq, pose_q(p))
    t = quat_rotate(dq, pose_t(p)) + xi[..., 3:]
    return make_pose(q, t)


def pose_log(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([so3_log(pose_q(p)), pose_t(p)], -1)


def constant_velocity_extrapolate(prev: torch.Tensor, cur: torch.Tensor,
                                  steps: float = 1.0) -> torch.Tensor:
    """next = (cur * prev^-1)^steps * cur (EstimateNextPoseFromHistory)."""
    delta = pose_compose(cur, pose_inverse(prev))
    omega = so3_log(pose_q(delta)) * steps
    t = pose_t(delta) * steps
    return pose_compose(make_pose(so3_exp(omega), t), cur)


def slerp(q0: torch.Tensor, q1: torch.Tensor, alpha) -> torch.Tensor:
    """Spherical interpolation of unit quaternions (linear for tiny
    angles)."""
    q0 = quat_normalize(q0)
    q1 = quat_normalize(q1)
    d = torch.sum(q0 * q1, -1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.abs(d)
    theta = torch.arccos(torch.clamp(d, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    lin = (1 - alpha) * q0 + alpha * q1
    w0 = torch.sin((1 - alpha) * theta) / torch.clamp(sin_theta, min=_EPS)
    w1 = torch.sin(alpha * theta) / torch.clamp(sin_theta, min=_EPS)
    out = torch.where(sin_theta < 1e-6, lin, w0 * q0 + w1 * q1)
    return quat_normalize(out)


def pose_interpolate(a: torch.Tensor, b: torch.Tensor, alpha) -> torch.Tensor:
    """Slerp the rotation, lerp the translation."""
    q = slerp(pose_q(a), pose_q(b), alpha)
    t = (1 - alpha) * pose_t(a) + alpha * pose_t(b)
    return make_pose(q, t)
