"""Global bundle adjustment over the whole map (used by fossilize).

Port of the single-device half of ``mageslam_tpu/mapping/global_ba.py``.
Distributed and trajectory-sharded global BA belong to the parallel layer,
which is not ported: ``engine_global_bundle_adjust`` raises if the
settings ask for them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mageslam_tpu_torch.mapstore import map_state as ms
from mageslam_tpu_torch.ops import util
from mageslam_tpu_torch.solvers.bundle_adjust import (BAProblem,
                                                      bundle_adjust,
                                                      empty_tethers)


class GlobalBAWindow(NamedTuple):
    problem: BAProblem
    kf_list: torch.Tensor
    kf_list_valid: torch.Tensor
    mp_list: torch.Tensor
    mp_list_valid: torch.Tensor


def build_global_problem(m: ms.MapState,
                         max_obs_per_point: int = 12) -> GlobalBAWindow:
    K, F, L = ms.capacities(m)
    M = max_obs_per_point
    dev = m.kf_pose.device
    mem = ms.member_matrix(m)
    score = mem.to(torch.float32) \
        - torch.arange(K, dtype=torch.float32, device=dev)[:, None] * 1e-6
    vals, kf_of_obs = util.topk(score.T, M)                  # (L, M)
    obs_ok = vals > 0.5
    feat_of = ms.feat_index_of_points(m, torch.arange(K, device=dev))
    kclip = torch.clamp(kf_of_obs, 0, K - 1)
    feat_sel = feat_of[kclip, torch.arange(L, device=dev)[:, None]]
    obs_ok &= feat_sel >= 0
    obs_xn = m.kf_xn[kclip, torch.clamp(feat_sel, 0, F - 1).long()]
    # gauge: freeze the two oldest keyframes
    fid = torch.where(m.kf_valid, m.kf_frame_id,
                      torch.full_like(m.kf_frame_id, 2 ** 30))
    order_old = util.argsort(fid)
    ar = torch.arange(K, device=dev)
    kf_fixed = (~m.kf_valid) | (ar == order_old[0]) | (ar == order_old[1])
    problem = BAProblem(
        kf_poses=m.kf_pose, kf_fixed=kf_fixed, points=m.mp_pos,
        point_valid=m.mp_valid, obs_kf=kclip.to(torch.int32),
        obs_xn=obs_xn, obs_valid=obs_ok & m.mp_valid[:, None],
        **empty_tethers(0, dev))
    return GlobalBAWindow(problem, torch.arange(K, dtype=torch.int32,
                                                device=dev), m.kf_valid,
                          torch.arange(L, dtype=torch.int32, device=dev),
                          m.mp_valid)


def global_bundle_adjust(m: ms.MapState, huber_delta, max_outlier_error,
                         num_steps: int = 10, lam0=1e-4,
                         max_obs_per_point: int = 12):
    """Build + solve + write back; returns (map, BAResult)."""
    win = build_global_problem(m, max_obs_per_point)
    res = bundle_adjust(win.problem, huber_delta, max_outlier_error,
                        num_steps=num_steps, lam0=lam0)
    m2 = ms.apply_ba_update(m, win.kf_list, win.kf_list_valid, res.kf_poses,
                            win.mp_list, win.mp_list_valid, res.points)
    return m2, res


def engine_global_bundle_adjust(m: ms.MapState, settings, fx: float,
                                num_steps: int, lam0,
                                huber_width_px: float | None = None,
                                max_outlier_px: float | None = None):
    """Global BA for the engine paths (fossilize, the host engine's loop
    closure), at the settings' Huber width and outlier gate unless the
    caller names others (in pixels)."""
    p = settings.parallel
    if p.use_distributed_global_ba or p.use_trajectory_sharding:
        raise NotImplementedError(
            "distributed / trajectory-sharded global BA belong to the "
            "parallel layer, which is not ported yet")
    px = 1.0 / fx
    if huber_width_px is None:
        huber_width_px = settings.bundle_adjust.huber_width
    if max_outlier_px is None:
        max_outlier_px = settings.graph_optimization.max_outlier_error
    hd = float(torch.tensor(huber_width_px * px, dtype=torch.float32))
    moe = float(torch.tensor(max_outlier_px * px, dtype=torch.float32))
    return global_bundle_adjust(m, hd, moe, num_steps=num_steps, lam0=lam0)


def global_ba_to_floor(m: ms.MapState, settings, fx: float, lam0,
                       chunk_steps: int = 10, max_steps: int = 60,
                       rel_tol: float = 0.01):
    """Iterate global BA in chunks until the inlier MSE stops improving
    by rel_tol (one host read of the MSE per chunk)."""
    prev = None
    lam = lam0
    total = 0
    res = None
    while total < max_steps:
        m, res = engine_global_bundle_adjust(m, settings, fx,
                                             num_steps=chunk_steps,
                                             lam0=lam)
        lam = res.lam
        mse = float(res.mean_sq_error)
        total += chunk_steps
        if prev is not None and (prev - mse) <= rel_tol * max(prev, 1e-12):
            break
        prev = mse
    return m, res
