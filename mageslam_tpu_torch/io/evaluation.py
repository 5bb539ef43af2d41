"""Trajectory evaluation: Sim3-aligned ATE and RPE.

Port of ``mageslam_tpu/io/evaluation.py`` (which imports jax).  The ATE is
float64 numpy (Umeyama); the RPE goes through the port's float32 se3 /
sim3 on the CPU, as the JAX evaluator's arithmetic does.
"""

from __future__ import annotations

import numpy as np
import torch

from mageslam_tpu_torch.geometry import se3, sim3


def _quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    qv = q[..., 1:]
    uv = np.cross(qv, v)
    uuv = np.cross(qv, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def camera_centers(view_poses: np.ndarray) -> np.ndarray:
    """C = -R^T t for (N, 7) [qw qx qy qz tx ty tz] view poses."""
    p = np.asarray(view_poses, np.float64)
    qc = p[..., :4] * np.array([1.0, -1.0, -1.0, -1.0])
    return -_quat_rotate(qc, p[..., 4:])


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """(s, R, t) with dst ~ s R src + t (Umeyama 1991)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    U, S, Vt = np.linalg.svd(cov)
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U) * np.linalg.det(Vt))
    R = U @ D @ Vt
    var_s = np.mean(np.sum(sc * sc, -1))
    s = float(np.trace(np.diag(S) @ D) / max(var_s, 1e-12)) \
        if with_scale else 1.0
    return s, R, mu_d - s * R @ mu_s


def ate_rmse(est_view_poses, gt_view_poses, with_scale: bool = True):
    """Sim3-aligned absolute trajectory error of camera centres.
    Returns (rmse, aligned_est_centers, gt_centers)."""
    est_c = camera_centers(est_view_poses)
    gt_c = camera_centers(gt_view_poses)
    s, R, t = umeyama(est_c, gt_c, with_scale)
    aligned = s * est_c @ R.T + t
    err = np.linalg.norm(aligned - gt_c, axis=-1)
    return float(np.sqrt(np.mean(err ** 2))), aligned, gt_c


def rpe_stats(est_view_poses: np.ndarray, gt_view_poses: np.ndarray,
              delta: int = 1):
    """Relative pose error over frame gaps of ``delta``, after scaling the
    estimate by its Sim3 alignment: (translation RMSE, rotation RMSE in
    radians).  float32 through the port's se3 / sim3, as the JAX
    evaluator computes it."""
    est = torch.as_tensor(np.asarray(est_view_poses, np.float32))
    gt = torch.as_tensor(np.asarray(gt_view_poses, np.float32))
    g = sim3.umeyama_alignment(se3.camera_center(est),
                               se3.camera_center(gt))
    s = float(sim3.sim3_s(g).reshape(-1)[0])
    e_rel = se3.pose_compose(est[delta:], se3.pose_inverse(est[:-delta]))
    g_rel = se3.pose_compose(gt[delta:], se3.pose_inverse(gt[:-delta]))
    dt = np.linalg.norm(s * se3.pose_t(e_rel).numpy()
                        - se3.pose_t(g_rel).numpy(), axis=-1)
    dr = np.linalg.norm(se3.so3_log(se3.quat_mul(
        se3.pose_q(e_rel), se3.quat_conj(se3.pose_q(g_rel)))).numpy(),
        axis=-1)
    return float(np.sqrt(np.mean(np.square(dt)))), \
        float(np.sqrt(np.mean(np.square(dr))))
