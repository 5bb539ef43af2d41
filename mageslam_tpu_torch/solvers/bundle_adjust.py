"""Levenberg-Marquardt bundle adjustment with a dense Schur complement.

Port of ``mageslam_tpu/solvers/bundle_adjust.py``.  The problem is the
same landmark-major fixed-shape table: observations live in an (L, M)
slot grid, landmark blocks are eliminated in closed form, and the camera
system is assembled through a one-hot routing matrix and solved densely.
Reprojection Jacobians are analytic.  The JAX package differentiates its
tether residual with ``jax.jacfwd``; here the DISTANCE tether's Jacobian is
written out (the residual |C_i - C_j| - d depends only on the translation
part of each left update, through -R^T), and so are the SIX_DOF /
EXTRINSIC tethers' (``_pose_tether_jacobians``: SO(3) left and right
Jacobians; forward-mode autograd gave the same blocks but went through
PyTorch's Python decompositions, seconds on a first call).  They cost a
few dozen small launches per LM step, so a caller whose problem holds no
pose tether by construction (the engine's local window) says so with
``pose_tethers=False``.

Solves use ``torch.linalg.solve_ex``, which reports singularity in a
tensor instead of raising, so an LM step never synchronises with the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mageslam_tpu_torch.geometry import se3
from mageslam_tpu_torch.ops import util
from mageslam_tpu_torch.solvers.pnp import (huber_weights,
                                            pose_jacobian_from_camera_points,
                                            projection_jacobian)

TETHER_NONE = 0
TETHER_DISTANCE = 1
TETHER_SIX_DOF = 2
TETHER_EXTRINSIC = 3


class BAProblem(NamedTuple):
    """K keyframes, L landmarks, M observation slots, T tether slots."""

    kf_poses: torch.Tensor     # (K, 7)
    kf_fixed: torch.Tensor     # (K,) bool
    points: torch.Tensor       # (L, 3)
    point_valid: torch.Tensor  # (L,) bool
    obs_kf: torch.Tensor       # (L, M) int32
    obs_xn: torch.Tensor       # (L, M, 2)
    obs_valid: torch.Tensor    # (L, M) bool
    tether_i: torch.Tensor     # (T,) int32
    tether_j: torch.Tensor     # (T,) int32
    tether_type: torch.Tensor  # (T,) int32
    tether_pose: torch.Tensor  # (T, 7)
    tether_dist: torch.Tensor  # (T,)
    tether_weight: torch.Tensor  # (T,)


def empty_tethers(t: int = 0, device=None) -> dict:
    pose = se3.pose_identity(device).expand(t, 7).clone()
    return dict(
        tether_i=torch.zeros(t, dtype=torch.int32, device=device),
        tether_j=torch.zeros(t, dtype=torch.int32, device=device),
        tether_type=torch.zeros(t, dtype=torch.int32, device=device),
        tether_pose=pose,
        tether_dist=torch.zeros(t, dtype=torch.float32, device=device),
        tether_weight=torch.zeros(t, dtype=torch.float32, device=device),
    )


class BAResult(NamedTuple):
    kf_poses: torch.Tensor
    points: torch.Tensor
    mean_sq_error: torch.Tensor
    lam: torch.Tensor
    outliers: torch.Tensor
    num_inlier_obs: torch.Tensor


def _project_obs(kf_poses, points, obs_kf):
    poses = kf_poses[obs_kf.long()]                   # (L, M, 7)
    y = se3.pose_apply(poses, points[:, None, :])
    z = y[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    return y[..., :2] / zs[..., None], z, y, poses


def _residuals(problem: BAProblem, kf_poses, points):
    xn, z, _, _ = _project_obs(kf_poses, points, problem.obs_kf)
    r = xn - problem.obs_xn
    good = problem.obs_valid & problem.point_valid[:, None] & (z > 0)
    return r, good, z


def _tether_residual(pose_i, pose_j, ttype, target_pose, target_dist):
    """(T, 6) stacked tether residuals (DISTANCE uses the first entry)."""
    rel = se3.pose_compose(pose_i, se3.pose_inverse(pose_j))
    r6 = se3.pose_log(se3.pose_compose(rel, se3.pose_inverse(target_pose)))
    v = se3.camera_center(pose_i) - se3.camera_center(pose_j) + 1e-12
    rd = torch.linalg.vector_norm(v, dim=-1) - target_dist
    rdist = torch.cat([rd[..., None], torch.zeros_like(r6[..., :5])], -1)
    r = torch.where((ttype == TETHER_DISTANCE)[..., None], rdist, r6)
    return torch.where((ttype == TETHER_NONE)[..., None],
                       torch.zeros_like(r), r)


def tether_error(kf_poses, tether_i, tether_j, tether_type, tether_pose,
                 tether_dist, tether_weight) -> torch.Tensor:
    if tether_i.numel() == 0:
        return kf_poses.new_zeros(())
    rt = _tether_residual(kf_poses[tether_i.long()], kf_poses[tether_j.long()],
                          tether_type, tether_pose, tether_dist)
    return torch.sum(tether_weight * torch.sum(rt * rt, -1))


def _error(problem: BAProblem, kf_poses, points, huber_delta):
    r, good, z = _residuals(problem, kf_poses, points)
    err = torch.sum(r * r, -1)
    d2 = huber_delta ** 2
    rho = torch.where(err <= d2, err,
                      2.0 * huber_delta * torch.sqrt(torch.clamp(err, min=d2))
                      - d2)
    e = torch.sum(torch.where(good, rho, torch.zeros_like(rho)))
    # cheirality penalty: an observation behind its camera must not leave
    # the cost (see the JAX package's note on collapsing scale)
    behind = problem.obs_valid & problem.point_valid[:, None] & (z <= 0)
    e = e + torch.sum(behind.to(torch.float32))
    e_t = tether_error(kf_poses, problem.tether_i, problem.tether_j,
                       problem.tether_type, problem.tether_pose,
                       problem.tether_dist, problem.tether_weight)
    return e + e_t, good


def _inv3x3(V: torch.Tensor) -> torch.Tensor:
    a, b, c = V[..., 0, 0], V[..., 0, 1], V[..., 0, 2]
    d, e, f = V[..., 1, 0], V[..., 1, 1], V[..., 1, 2]
    g, h, i = V[..., 2, 0], V[..., 2, 1], V[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12),
                      det)
    inv = torch.stack([A, B, C, D, E, F, G, H, I], -1) / det[..., None]
    return inv.reshape(V.shape)


def _pose_tether_jacobians(pi, pj, target_pose):
    """(T, 6, 12) d r / d [xi_i, xi_j] at xi = 0 of the SIX_DOF / EXTRINSIC
    residual r = [log R_E, t_E], E = P_i P_j^-1 T^-1, under the left
    updates P <- (Exp w, rho) P.  Left on P_i, ``log`` moves by the inverse
    left Jacobian; on P_j the update reaches R_E from the right as
    Exp(-R_T w_j), through the inverse right Jacobian."""
    E = se3.pose_compose(se3.pose_compose(pi, se3.pose_inverse(pj)),
                         se3.pose_inverse(target_pose))
    phi = se3.so3_log(se3.pose_q(E))
    t_e = se3.pose_t(E)
    Ri = se3.quat_to_mat(se3.pose_q(pi))
    Rj = se3.quat_to_mat(se3.pose_q(pj))
    Rt = se3.quat_to_mat(se3.pose_q(target_pose))
    M = Ri @ Rj.transpose(-1, -2)
    c = -(Rt.transpose(-1, -2) @ se3.pose_t(target_pose)[..., None])[..., 0]
    th2 = torch.sum(phi * phi, -1)[..., None, None]
    th = torch.sqrt(th2)
    # 1/th^2 - (1 + cos th) / (2 th sin th), its series below 1e-3 rad
    a = torch.where(
        th2 < 1e-6, 1.0 / 12.0 + th2 / 720.0,
        1.0 / torch.clamp(th2, min=1e-12) - (1.0 + torch.cos(th))
        / torch.clamp(2.0 * th * torch.sin(th), min=1e-12))
    P = se3.hat(phi)
    P2 = P @ P
    eye = torch.eye(3, dtype=pi.dtype, device=pi.device).expand_as(P)
    jl_inv = eye - 0.5 * P + a * P2
    jr_inv = eye + 0.5 * P + a * P2
    zero = torch.zeros_like(P)
    return torch.cat([
        torch.cat([jl_inv, zero, -jr_inv @ Rt, zero], -1),
        torch.cat([-se3.hat(t_e), eye, M @ se3.hat(c), -M], -1)], -2)


def tether_normal_contrib(kf_poses, tether_i, tether_j, tether_type,
                          tether_pose, tether_dist, tether_weight,
                          pose_tethers: bool = True):
    """(S_t (K+1, K+1, 6, 6), b_t (K+1, 6)); row K collects disabled
    slots.  With ``pose_tethers=False`` SIX_DOF / EXTRINSIC slots are
    taken to be absent and contribute nothing."""
    K = kf_poses.shape[0]
    dev, dt = kf_poses.device, kf_poses.dtype
    S = torch.zeros((K + 1, K + 1, 6, 6), dtype=dt, device=dev)
    b = torch.zeros((K + 1, 6), dtype=dt, device=dev)
    T = tether_i.shape[0]
    if T == 0:
        return S, b
    pi = kf_poses[tether_i.long()]
    pj = kf_poses[tether_j.long()]
    v = se3.camera_center(pi) - se3.camera_center(pj) + 1e-12
    nv = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    u = v / nv
    is_dist = (tether_type == TETHER_DISTANCE)[:, None]
    # d|C_i - C_j| / d(xi_i) = [0, -(R_i u)^T], / d(xi_j) = [0, (R_j u)^T]
    Ri = se3.quat_to_mat(se3.pose_q(pi))
    Rj = se3.quat_to_mat(se3.pose_q(pj))
    zero3 = torch.zeros_like(u)
    zero6 = torch.zeros_like(pi[:, :6])
    gi = torch.where(is_dist, torch.cat(
        [zero3, -(Ri @ u[..., None])[..., 0]], -1), zero6)
    gj = torch.where(is_dist, torch.cat(
        [zero3, (Rj @ u[..., None])[..., 0]], -1), zero6)
    rt = _tether_residual(pi, pj, tether_type, tether_pose, tether_dist)
    sw = torch.sqrt(tether_weight)[:, None]
    # (T, 6, 6) Jacobians: only the first residual row is non-zero
    Ji = torch.zeros((T, 6, 6), dtype=dt, device=dev)
    Jj = torch.zeros((T, 6, 6), dtype=dt, device=dev)
    Ji[:, 0] = gi * sw
    Jj[:, 0] = gj * sw
    if pose_tethers:
        J6 = _pose_tether_jacobians(pi, pj, tether_pose)
        six = (tether_type >= TETHER_SIX_DOF)[:, None, None]
        Ji = torch.where(six, J6[..., :6] * sw[..., None], Ji)
        Jj = torch.where(six, J6[..., 6:] * sw[..., None], Jj)
    rt = rt * sw
    on = tether_type > 0
    ti = torch.where(on, tether_i, torch.full_like(tether_i, K)).long()
    tj = torch.where(on, tether_j, torch.full_like(tether_j, K)).long()
    S.index_put_((ti, ti), torch.einsum("tab,tac->tbc", Ji, Ji),
                 accumulate=True)
    S.index_put_((tj, tj), torch.einsum("tab,tac->tbc", Jj, Jj),
                 accumulate=True)
    S.index_put_((ti, tj), torch.einsum("tab,tac->tbc", Ji, Jj),
                 accumulate=True)
    S.index_put_((tj, ti), torch.einsum("tab,tac->tbc", Jj, Ji),
                 accumulate=True)
    b.index_put_((ti,), -torch.einsum("tab,ta->tb", Ji, rt), accumulate=True)
    b.index_put_((tj,), -torch.einsum("tab,ta->tb", Jj, rt), accumulate=True)
    return S, b


def _build_normal_eq(problem: BAProblem, kf_poses, points, huber_delta,
                     lam, pose_tethers: bool = True):
    """One linearization: (S, b, V_inv, W, g_p, kf_safe) with S the damped
    (K+1, K+1, 6, 6) Schur camera system (row K is scratch)."""
    K = kf_poses.shape[0]
    r, good, _ = _residuals(problem, kf_poses, points)
    _, _, y, poses = _project_obs(kf_poses, points, problem.obs_kf)
    rn = torch.linalg.vector_norm(r, dim=-1)
    w = huber_weights(rn, huber_delta) * good

    A = pose_jacobian_from_camera_points(y)             # (L, M, 2, 6)
    Rm = se3.quat_to_mat(se3.pose_q(poses))
    B = projection_jacobian(y) @ Rm                     # (L, M, 2, 3)
    A = A * w[..., None, None]
    B = B * w[..., None, None]
    rw = r * w[..., None]

    V = torch.einsum("lmab,lmac->lbc", B, B)
    g_p = -torch.einsum("lmab,lma->lb", B, rw)
    V = V + torch.diag_embed(lam * torch.diagonal(V, dim1=-2, dim2=-1)
                             + 1e-8)
    V_inv = _inv3x3(V)

    W = torch.einsum("lmab,lmac->lmbc", A, B)           # (L, M, 6, 3)
    Y = torch.einsum("lmbc,lcd->lmbd", W, V_inv)

    # route every observation slot to its keyframe with a one-hot matrix
    # (deterministic dense contractions instead of atomic scatter-adds)
    kf_safe = torch.where(good, problem.obs_kf,
                          torch.full_like(problem.obs_kf, K)).long()
    O = torch.nn.functional.one_hot(kf_safe, K + 1).to(A.dtype)
    AA = torch.einsum("lmab,lmac->lmbc", A, A)
    U = torch.einsum("lmk,lmbc->kbc", O, AA)
    Ar = torch.einsum("lmab,lma->lmb", A, rw)
    g_c = -torch.einsum("lmk,lmb->kb", O, Ar)

    S, b_t = tether_normal_contrib(
        kf_poses, problem.tether_i, problem.tether_j, problem.tether_type,
        problem.tether_pose, problem.tether_dist, problem.tether_weight,
        pose_tethers)
    diag = torch.arange(K + 1, device=S.device)
    S[diag, diag] += U
    b = g_c + b_t
    Yk = torch.einsum("lmk,lmab->lkab", O, Y)
    Wk = torch.einsum("lmk,lmab->lkab", O, W)
    S = S - torch.einsum("lkab,lqcb->kqac", Yk, Wk)
    b = b - torch.einsum("lkab,lb->ka", Yk, g_p)
    return S, b, V_inv, W, g_p, kf_safe


def _solve_schur(S, b, kf_fixed, lam):
    """Dense damped camera solve with fixed poses masked out."""
    K = kf_fixed.shape[0]
    S = S[:K, :K]
    b = b[:K]
    free = ~kf_fixed
    mask2 = free[:, None] & free[None, :]
    S = S * mask2[:, :, None, None]
    diag = torch.arange(K, device=S.device)
    eye6 = torch.eye(6, dtype=S.dtype, device=S.device)
    Sd_blocks = S[diag, diag]                           # (K, 6, 6)
    damp = lam * torch.diag_embed(torch.diagonal(Sd_blocks, dim1=-2,
                                                 dim2=-1))
    Sd_blocks = Sd_blocks + (damp + 1e-8 * eye6)
    Sd_blocks = Sd_blocks + torch.where(kf_fixed[:, None, None], eye6,
                                        torch.zeros_like(eye6))
    S = S.clone()
    S[diag, diag] = Sd_blocks
    b = b * free[:, None]
    Sd = S.permute(0, 2, 1, 3).reshape(K * 6, K * 6)
    dx = torch.linalg.solve_ex(Sd, b.reshape(K * 6)).result
    return dx.reshape(K, 6) * free[:, None]


def bundle_adjust_impl(problem: BAProblem, huber_delta, max_outlier_error,
                       num_steps: int = 5, lam0=1e-4,
                       pose_tethers: bool = True) -> BAResult:
    """num_steps LM iterations with accept/reject and a persisted lambda;
    returns the inlier mean square error and the outlier observations.
    ``pose_tethers=False``: the problem holds no SIX_DOF / EXTRINSIC
    tether (their Jacobians are then not formed)."""
    dev = problem.points.device
    # huber_delta / max_outlier_error may be Python floats holding float32
    # values: torch applies them as float32 scalars, as JAX does
    lam = util.full(lam0, dev, torch.float32)
    poses, points = problem.kf_poses, problem.points
    for _ in range(num_steps):
        err0, _ = _error(problem, poses, points, huber_delta)
        S, b, V_inv, W, g_p, kf_safe = _build_normal_eq(
            problem, poses, points, huber_delta, lam, pose_tethers)
        dc = _solve_schur(S, b, problem.kf_fixed, lam)
        dc_pad = torch.cat([dc, dc.new_zeros((1, 6))], 0)
        Wtdc = torch.einsum("lmbc,lmb->lc", W, dc_pad[kf_safe])
        dp = torch.einsum("lbc,lc->lb", V_inv, g_p - Wtdc)
        dp = dp * problem.point_valid[:, None]
        new_poses = se3.pose_retract(poses, dc)
        new_points = points + dp
        err1, _ = _error(problem, new_poses, new_points, huber_delta)
        accept = err1 < err0
        poses = torch.where(accept, new_poses, poses)
        points = torch.where(accept, new_points, points)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                          1e-7, 1e3)

    r, good, _ = _residuals(problem, poses, points)
    err = torch.sum(r * r, -1)
    outliers = good & (err > max_outlier_error ** 2)
    inl = good & ~outliers
    n_inl = torch.sum(inl)
    sum_err = torch.sum(torch.where(inl, err, torch.zeros_like(err)))
    mse = sum_err / torch.clamp(n_inl, min=1)
    return BAResult(poses, points, mse, lam, outliers, n_inl)


bundle_adjust = bundle_adjust_impl
