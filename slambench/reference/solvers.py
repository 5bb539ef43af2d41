"""Plain references of the two solvers on the timed path, in any dtype.

- ``refine_pose``: tracking's pose-only robust Gauss-Newton (IRLS with
  Huber weights over all matches, then again over the first stage's
  inliers), a fixed number of damped steps.
- ``local_ba``: the mapping's Levenberg-Marquardt bundle adjustment of a
  local window (keyframe poses and landmarks, Huber-weighted
  reprojections, a cheirality penalty, landmarks eliminated by the Schur
  complement, accept/reject with a persisted lambda), for windows without
  pose tethers.

Both follow the program's algorithm step for step from the program's own
inputs (its matches, its window), so that what remains between the two
is the arithmetic.  They are frozen copies written out in plain PyTorch
and import nothing of the program.  Poses are (7,) [qw qx qy qz tx ty tz],
camera-from-world; normalized image coordinates throughout.
"""

from __future__ import annotations

import torch

EPS = 1e-8


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], -1)


def quat_normalize(q):
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                        min=EPS)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_mul(a, b):
    a, b = torch.broadcast_tensors(a, b)
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def quat_rotate(q, v):
    qv = q[..., 1:]
    uv = _cross(qv, v)
    return v + 2.0 * (q[..., :1] * uv + _cross(qv, uv))


def quat_to_mat(q):
    w, x, y, z = q.unbind(-1)
    m = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y), 2 * (x * y + w * z),
                     1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                     2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)
    return m.reshape(m.shape[:-1] + (3, 3))


def hat(w):
    ox, oy, oz = w.unbind(-1)
    z = torch.zeros_like(ox)
    m = torch.stack([z, -oz, oy, oz, z, -ox, -oy, ox, z], -1)
    return m.reshape(m.shape[:-1] + (3, 3))


def so3_exp(omega):
    th2 = torch.sum(omega * omega, -1, keepdim=True)
    th = torch.sqrt(torch.clamp(th2, min=0.0))
    small = th2 < 1e-10
    k = torch.where(small, 0.5 - th2 / 48.0,
                    torch.sin(0.5 * th) / torch.clamp(th, min=EPS))
    w = torch.where(small, 1.0 - th2 / 8.0, torch.cos(0.5 * th))
    return quat_normalize(torch.cat([w, k * omega], -1))


def pose_apply(p, x):
    return quat_rotate(p[..., :4], x) + p[..., 4:]


def pose_retract(p, xi):
    """Left update T <- Exp(xi) T."""
    dq = so3_exp(xi[..., :3])
    q = quat_normalize(quat_mul(dq, p[..., :4]))
    t = quat_rotate(dq, p[..., 4:]) + xi[..., 3:]
    return torch.cat([q, t], -1)


def solve(A, b):
    """``A x = b``; the factorization runs in float32 for half-precision
    operands (no half-precision LU exists) and the answer is rounded
    back."""
    if A.dtype in (torch.float16, torch.bfloat16):
        return torch.linalg.solve(A.float(), b.float()).to(A.dtype)
    return torch.linalg.solve(A, b)


def _safe_z(z):
    return torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def _proj_jac(y):
    iz = 1.0 / _safe_z(y[..., 2])
    iz2 = iz * iz
    zero = torch.zeros_like(iz)
    return torch.stack([torch.stack([iz, zero, -y[..., 0] * iz2], -1),
                        torch.stack([zero, iz, -y[..., 1] * iz2], -1)], -2)


def _pose_jac(y):
    hy = hat(y)
    eye = torch.eye(3, dtype=y.dtype, device=y.device).expand(hy.shape)
    return _proj_jac(y) @ torch.cat([-hy, eye], -1)


def _huber_w(rn, delta):
    return torch.sqrt(torch.clamp(delta / torch.clamp(rn, min=1e-12),
                                  max=1.0))


def project(pose, x):
    """Normalized projection (..., 2) and depth of world points."""
    y = pose_apply(pose, x)
    return y[..., :2] / _safe_z(y[..., 2])[..., None], y[..., 2]


# ------------------------------------------------------------ tracking
def refine_pose(pose0, points_w, xn_obs, valid, huber_delta: float,
                outlier_thresh: float, iters: int, damping: float = 1e-4):
    """(pose, inliers) after ``iters`` IRLS steps over every valid match
    and ``max(2, iters // 2)`` over the inliers of the first stage."""
    dt = points_w.dtype
    eye6 = torch.eye(6, dtype=dt, device=points_w.device)

    def step(pose, mask):
        y = pose_apply(pose[None], points_w)
        z = y[:, 2]
        r = y[:, :2] / _safe_z(z)[:, None] - xn_obs
        J = _pose_jac(y)
        w = _huber_w(torch.linalg.vector_norm(r, dim=-1), huber_delta) \
            * mask * (z > 0)
        Jw = J * w[:, None, None]
        rw = r * w[:, None]
        H = torch.einsum("nij,nik->jk", Jw, Jw)
        g = -torch.einsum("nij,ni->j", Jw, rw)
        H = H + damping * eye6 * (1.0 + torch.diagonal(H))[None, :]
        return pose_retract(pose, solve(H, g))

    def inliers(pose):
        xn, z = project(pose[None], points_w)
        err = torch.sum((xn - xn_obs) ** 2, -1)
        return valid & (z > 0) & (err < outlier_thresh ** 2)

    pose = pose0
    vmask = valid.to(dt)
    for _ in range(iters):
        pose = step(pose, vmask)
    w2 = inliers(pose).to(dt)
    for _ in range(max(2, iters // 2)):
        pose = step(pose, w2)
    return pose, inliers(pose)


# ------------------------------------------------------------- mapping
def _residuals(p, poses, points):
    y = pose_apply(poses[p["obs_kf"].long()], points[:, None, :])
    z = y[..., 2]
    r = y[..., :2] / _safe_z(z)[..., None] - p["obs_xn"]
    good = p["obs_valid"] & p["point_valid"][:, None] & (z > 0)
    return r, good, z, y


def ba_error(p, poses, points, delta: float):
    """Huber cost of the window plus one per observation behind its
    camera."""
    r, good, z, _ = _residuals(p, poses, points)
    err = torch.sum(r * r, -1)
    d2 = delta ** 2
    rho = torch.where(err <= d2, err,
                      2.0 * delta * torch.sqrt(torch.clamp(err, min=d2)) - d2)
    e = torch.sum(torch.where(good, rho, torch.zeros_like(rho)))
    behind = p["obs_valid"] & p["point_valid"][:, None] & (z <= 0)
    return e + torch.sum(behind.to(e.dtype))


def _inv3x3(V):
    a, b, c = V[..., 0, 0], V[..., 0, 1], V[..., 0, 2]
    d, e, f = V[..., 1, 0], V[..., 1, 1], V[..., 1, 2]
    g, h, i = V[..., 2, 0], V[..., 2, 1], V[..., 2, 2]
    A, B, C = e * i - f * h, c * h - b * i, b * f - c * e
    D, E, F_ = f * g - d * i, a * i - c * g, c * d - a * f
    G, H, I_ = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12),
                      det)
    inv = torch.stack([A, B, C, D, E, F_, G, H, I_], -1) / det[..., None]
    return inv.reshape(V.shape)


def _lm_step(p, poses, points, delta, lam):
    """One damped Schur-complement step: (new poses, new points)."""
    K = poses.shape[0]
    r, good, _, y = _residuals(p, poses, points)
    w = _huber_w(torch.linalg.vector_norm(r, dim=-1), delta) * good
    A = _pose_jac(y)                                        # (L, M, 2, 6)
    Rm = quat_to_mat(poses[p["obs_kf"].long()][..., :4])
    B = _proj_jac(y) @ Rm                                   # (L, M, 2, 3)
    A = A * w[..., None, None]
    B = B * w[..., None, None]
    rw = r * w[..., None]
    V = torch.einsum("lmab,lmac->lbc", B, B)
    g_p = -torch.einsum("lmab,lma->lb", B, rw)
    V = V + torch.diag_embed(lam * torch.diagonal(V, dim1=-2, dim2=-1)
                             + 1e-8)
    V_inv = _inv3x3(V)
    W = torch.einsum("lmab,lmac->lmbc", A, B)
    Y = torch.einsum("lmbc,lcd->lmbd", W, V_inv)
    kf = torch.where(good, p["obs_kf"],
                     torch.full_like(p["obs_kf"], K)).long()
    O = torch.nn.functional.one_hot(kf, K + 1).to(A.dtype)
    U = torch.einsum("lmk,lmbc->kbc", O,
                     torch.einsum("lmab,lmac->lmbc", A, A))
    b = -torch.einsum("lmk,lmb->kb", O, torch.einsum("lmab,lma->lmb", A, rw))
    S = torch.zeros((K + 1, K + 1, 6, 6), dtype=A.dtype, device=A.device)
    diag = torch.arange(K + 1, device=A.device)
    S[diag, diag] += U
    Yk = torch.einsum("lmk,lmab->lkab", O, Y)
    Wk = torch.einsum("lmk,lmab->lkab", O, W)
    S = S - torch.einsum("lkab,lqcb->kqac", Yk, Wk)
    b = b - torch.einsum("lkab,lb->ka", Yk, g_p)
    # dense damped camera solve, fixed keyframes masked out
    S, b = S[:K, :K], b[:K]
    free = ~p["kf_fixed"]
    S = S * (free[:, None] & free[None, :])[:, :, None, None]
    d = torch.arange(K, device=A.device)
    eye6 = torch.eye(6, dtype=A.dtype, device=A.device)
    blocks = S[d, d]
    blocks = blocks + lam * torch.diag_embed(
        torch.diagonal(blocks, dim1=-2, dim2=-1)) + 1e-8 * eye6
    blocks = blocks + torch.where(p["kf_fixed"][:, None, None], eye6,
                                  torch.zeros_like(eye6))
    S = S.clone()
    S[d, d] = blocks
    b = b * free[:, None]
    dc = solve(S.permute(0, 2, 1, 3).reshape(K * 6, K * 6),
               b.reshape(K * 6)).reshape(K, 6) * free[:, None]
    dc_pad = torch.cat([dc, dc.new_zeros((1, 6))], 0)
    dp = torch.einsum("lbc,lc->lb", V_inv,
                      g_p - torch.einsum("lmbc,lmb->lc", W, dc_pad[kf]))
    dp = dp * p["point_valid"][:, None]
    return pose_retract(poses, dc), points + dp


def local_ba(p: dict, delta: float, num_steps: int, lam0: float):
    """(poses, points, lam) after ``num_steps`` LM steps of the window
    ``p`` (keys ``kf_poses kf_fixed points point_valid obs_kf obs_xn
    obs_valid``), each step kept only where it lowers the cost."""
    dt = p["points"].dtype
    lam = torch.tensor(lam0, dtype=dt, device=p["points"].device)
    poses, points = p["kf_poses"], p["points"]
    for _ in range(num_steps):
        e0 = ba_error(p, poses, points, delta)
        new_poses, new_points = _lm_step(p, poses, points, delta, lam)
        accept = ba_error(p, new_poses, new_points, delta) < e0
        poses = torch.where(accept, new_poses, poses)
        points = torch.where(accept, new_points, points)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                          1e-7, 1e3)
    return poses, points, lam
