"""Local bundle-adjustment window extraction and write-back.

Port of ``mageslam_tpu/mapping/local_ba.py``: window = centre + top
covisible keyframes above the adaptive threshold, W+WF keyframe slots
(WF fixed "distant" anchors), LB landmark slots with the centre's points
first, gauge pinned by freezing the oldest (and, with weak anchoring, the
second-oldest) window keyframe.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mageslam_tpu_torch.mapstore import map_state as ms
from mageslam_tpu_torch.ops import util
from mageslam_tpu_torch.solvers.bundle_adjust import (BAProblem, BAResult,
                                                      empty_tethers)


class LocalBAWindow(NamedTuple):
    problem: BAProblem
    kf_list: torch.Tensor        # (W+WF,) int32
    kf_list_valid: torch.Tensor  # (W+WF,)
    kf_adjustable: torch.Tensor  # (W+WF,)
    mp_list: torch.Tensor        # (LB,) int32
    mp_list_valid: torch.Tensor  # (LB,)


def build_local_window(m: ms.MapState, center_kf, covis_threshold,
                       window_size: int = 16, num_fixed: int = 8,
                       max_points: int = 2048) -> LocalBAWindow:
    K, F, L = ms.capacities(m)
    W, WF, LB = window_size, num_fixed, max_points
    dev = m.kf_pose.device
    center = util.full(center_kf, dev, torch.int64)
    cov = ms.covisibility(m)
    mem = ms.member_matrix(m)

    crow = torch.where(m.kf_valid, cov[center], torch.full_like(cov[0], -1))
    crow = crow.clone()
    crow[center] = -1
    vals, idx = util.topk(crow, W - 1)
    win_idx = torch.cat([center.to(torch.int32)[None], idx.to(torch.int32)])
    win_valid = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           vals >= covis_threshold])
    win_valid &= m.kf_valid[win_idx.long()]

    sel_kf = torch.zeros(K + 1, dtype=torch.bool, device=dev)
    sel_kf[torch.where(win_valid, win_idx,
                       torch.full_like(win_idx, K)).long()] = True
    sel_kf = sel_kf[:K]
    pt_mask = (mem & sel_kf[:, None]).any(0)
    center_obs = mem[center] & pt_mask
    prio = (torch.where(center_obs, 2, torch.where(pt_mask, 1, 0))
            * (L + 1) + torch.arange(L, device=dev))
    order = util.argsort(-prio)
    mp_list = order[:LB].to(torch.int32)
    mp_list_valid = pt_mask[mp_list.long()]

    sel_pt = torch.zeros(L + 1, dtype=torch.bool, device=dev)
    sel_pt[torch.where(mp_list_valid, mp_list,
                       torch.full_like(mp_list, L)).long()] = True
    obs_count = (mem & sel_pt[None, :L]).sum(1)
    obs_count = torch.where(m.kf_valid & ~sel_kf, obs_count,
                            torch.zeros_like(obs_count))
    fvals, fidx = util.topk(obs_count, WF)
    fix_valid = fvals > 0

    kf_list = torch.cat([win_idx, fidx.to(torch.int32)])
    kf_list_valid = torch.cat([win_valid, fix_valid])
    kf_adjustable = torch.cat([win_valid, torch.zeros(WF, dtype=torch.bool,
                                                      device=dev)])
    # gauge: freeze the oldest window keyframe, and the second-oldest too
    # when fewer than 4 distant anchors carry observations
    fid = torch.where(win_valid, m.kf_frame_id[win_idx.long()],
                      torch.full_like(win_idx, 2 ** 30))
    order_old = util.argsort(fid)
    kf_adjustable[order_old[0]] = False
    weak = fix_valid.sum() < 4
    kf_adjustable[order_old[1]] = kf_adjustable[order_old[1]] & ~weak

    feat_of = ms.feat_index_of_points(m, kf_list)            # (M, L)
    feat_sel = feat_of[:, torch.clamp(mp_list, 0, L - 1).long()]
    obs_valid = (feat_sel >= 0) & kf_list_valid[:, None] \
        & mp_list_valid[None, :]
    M = W + WF
    fclip = torch.clamp(feat_sel, 0, F - 1).long()
    obs_xn = m.kf_xn[kf_list.long()[:, None], fclip]          # (M, LB, 2)
    problem = BAProblem(
        kf_poses=m.kf_pose[kf_list.long()],
        kf_fixed=~kf_adjustable,
        points=m.mp_pos[torch.clamp(mp_list, 0, L - 1).long()],
        point_valid=mp_list_valid,
        obs_kf=torch.arange(M, dtype=torch.int32, device=dev)
        .expand(LB, M).clone(),
        obs_xn=obs_xn.permute(1, 0, 2).contiguous(),
        obs_valid=obs_valid.T.contiguous(),
        # one inert tether slot (type NONE), as in the JAX window
        **empty_tethers(1, dev))
    return LocalBAWindow(problem, kf_list, kf_list_valid, kf_adjustable,
                         mp_list, mp_list_valid)


def apply_window_result(m: ms.MapState, window: LocalBAWindow,
                        result: BAResult) -> ms.MapState:
    return ms.apply_ba_update(
        m, window.kf_list, window.kf_adjustable & window.kf_list_valid,
        result.kf_poses, window.mp_list, window.mp_list_valid,
        result.points)


def unassociate_outliers(m: ms.MapState, window: LocalBAWindow,
                         result: BAResult) -> ms.MapState:
    """Clear associations flagged as BA outliers."""
    K, F, L = ms.capacities(m)
    LB, M = result.outliers.shape
    feat_of = ms.feat_index_of_points(m, window.kf_list)
    feat_sel = feat_of[:, torch.clamp(window.mp_list, 0, L - 1).long()].T
    out = result.outliers & (feat_sel >= 0)
    kf_flat = window.kf_list[None, :].expand(LB, M).reshape(-1)
    feat_flat = torch.where(out, feat_sel,
                            torch.full_like(feat_sel, F)).reshape(-1)
    kf_safe = torch.where(out.reshape(-1), kf_flat,
                          torch.full_like(kf_flat, K))
    assoc = torch.nn.functional.pad(m.kf_assoc, (0, 1, 0, 1), value=-1)
    assoc[kf_safe.long(), feat_flat.long()] = -1
    return m._replace(kf_assoc=assoc[:K, :F].contiguous())


def ba_error_px(result: BAResult, fx: float) -> float:
    """The BA's inlier mean square error in pixels squared."""
    return float(result.mean_sq_error) * fx * fx
