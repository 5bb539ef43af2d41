"""New map-point creation around a fresh keyframe.

Port of ``mageslam_tpu/mapping/new_points.py``: match the new keyframe's
unassociated features against each of its NC covisible keyframes,
triangulate with the reprojection / parallax / distance-ratio / scale
gates, allocate the survivors in one call, then associate them in the pair
keyframes and widen to the other covisible keyframes by projection.  The
two ``lax.scan`` loops carry the map from one keyframe to the next, so they
stay sequential Python loops.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mageslam_tpu_torch.config import NewMapPointsCreationSettings
from mageslam_tpu_torch.geometry import se3, triangulation
from mageslam_tpu_torch.geometry.camera import CameraCalibration, project
from mageslam_tpu_torch.mapstore import map_state as ms
from mageslam_tpu_torch.ops import matching
from mageslam_tpu_torch.tracking.track import cos_deg_f32


class NewPointsResult(NamedTuple):
    map: ms.MapState
    num_created: torch.Tensor
    num_widened: torch.Tensor


def _safe_div(y):
    z = y[:, 2]
    return y[:, :2] / torch.where(torch.abs(z) < 1e-9,
                                  torch.full_like(z, 1e-9), z)[:, None]


def create_new_map_points(m: ms.MapState, new_kf, cal: CameraCalibration,
                          settings: NewMapPointsCreationSettings, fx: float,
                          num_candidates: int = 5,
                          scale_factor: float = 1.5) -> NewPointsResult:
    s = settings
    K, F, L = ms.capacities(m)
    dev = m.kf_pose.device
    px = 1.0 / fx
    kf_idx, kf_ok = ms.connected_keyframes(m, new_kf, min_shared=1,
                                           max_connected=num_candidates)
    pose_i = m.kf_pose[new_kf]
    unassoc_i = m.kf_feat_valid[new_kf] & (m.kf_assoc[new_kf] < 0)
    xn_i = m.kf_xn[new_kf]
    oct_i = m.kf_octave[new_kf]
    ones = torch.ones((F, 1), dtype=torch.float32, device=dev)
    thr = (s.max_epipolar_error * px) ** 2
    cos_par = cos_deg_f32(s.min_parallax_degrees)

    Xs, oks, idxs = [], [], []
    for c in range(kf_idx.shape[0]):
        kc, ok = kf_idx[c].long(), kf_ok[c]
        pose_c = m.kf_pose[kc]
        unassoc_c = m.kf_feat_valid[kc] & (m.kf_assoc[kc] < 0) & ok
        idx, _ = matching.match(
            m.kf_desc[new_kf], m.kf_desc[kc], unassoc_i & ok, unassoc_c,
            max_distance=s.initial_matcher.max_hamming_distance,
            min_difference=s.initial_matcher.min_hamming_difference)
        matched = idx >= 0
        ic = torch.clamp(idx, min=0).long()
        xn_c = m.kf_xn[kc][ic]
        X, tri_ok = triangulation.triangulate_midpoint(
            pose_i, pose_c, torch.cat([xn_i, ones], -1),
            torch.cat([xn_c, ones], -1))
        y_i = se3.pose_apply(pose_i, X)
        y_c = se3.pose_apply(pose_c, X)
        reproj_ok = (torch.sum((_safe_div(y_i) - xn_i) ** 2, -1) < thr) \
            & (torch.sum((_safe_div(y_c) - xn_c) ** 2, -1) < thr)
        par_ok = triangulation.parallax_cos(pose_i, pose_c, X) < cos_par
        baseline = torch.linalg.vector_norm(
            se3.camera_center(pose_i) - se3.camera_center(pose_c)) + 1e-9
        d_i = torch.linalg.vector_norm(X - se3.camera_center(pose_i), dim=-1)
        ratio_ok = (d_i / baseline) > s.min_accepted_distance_ratio
        scale_ok = torch.abs(oct_i - m.kf_octave[kc][ic]) <= 1
        ok_all = (matched & ok & tri_ok & (y_i[:, 2] > 0) & (y_c[:, 2] > 0)
                  & reproj_ok & par_ok & ratio_ok & scale_ok)
        Xs.append(X)
        oks.append(ok_all)
        idxs.append(idx)
    Xs, oks, idxs = torch.stack(Xs), torch.stack(oks), torch.stack(idxs)
    # a feature of Ki triangulated in several pairs keeps the first pair's
    # candidate (pairs ordered by covisibility)
    oki = oks.to(torch.int32)
    first = oks & ((torch.cumsum(oki, 0) - oki) == 0)

    NC = kf_idx.shape[0]
    Xf = Xs.reshape(NC * F, 3)
    okf = first.reshape(NC * F)
    feat_i = torch.arange(F, dtype=torch.int32, device=dev).repeat(NC)
    feat_c = idxs.reshape(NC * F)
    kc_f = kf_idx.repeat_interleave(F)

    desc = m.kf_desc[new_kf][feat_i.long()]
    ctr_i = se3.camera_center(pose_i)
    normal = Xf - ctr_i
    dist_i = torch.linalg.vector_norm(normal, dim=-1)
    normal = normal / torch.clamp(dist_i, min=1e-9)[:, None]
    oct_new = oct_i[feat_i.long()]
    max_dist = dist_i * scale_factor ** oct_new.to(torch.float32)
    m2, mp_ids = ms.allocate_map_points(m, Xf, desc, normal, new_kf, okf,
                                        octave=oct_new, max_dist=max_dist)
    created = mp_ids >= 0
    m2 = ms.set_associations(m2, new_kf, feat_i, mp_ids, created)
    for c in range(NC):
        kc = kf_idx[c]
        m2 = ms.set_associations(m2, kc.long(), feat_c, mp_ids,
                                 created & (kc_f == kc))

    is_new = torch.zeros(L + 1, dtype=torch.bool, device=dev)
    is_new[torch.where(created, mp_ids,
                       torch.full_like(mp_ids, L)).long()] = True
    is_new = is_new[:L]
    widened = torch.zeros((), dtype=torch.int64, device=dev)
    for c in range(NC):
        kc = kf_idx[c].long()
        uv_pred, z = project(cal, se3.pose_apply(m2.kf_pose[kc][None],
                                                 m2.mp_pos))
        unassoc_c = m2.kf_feat_valid[kc] & (m2.kf_assoc[kc] < 0)
        idx2, dist2 = matching.radius_match(
            uv_pred, m2.mp_desc, is_new & (z > 0), m2.kf_uv[kc],
            m2.kf_desc[kc], unassoc_c,
            radius=s.new_map_points_search_radius,
            max_distance=s.associate_matcher.max_hamming_distance,
            min_difference=s.associate_matcher.min_hamming_difference)
        idx2 = matching.assign_unique(idx2, dist2)
        sel = idx2 >= 0
        widened = widened + sel.sum()
        m2 = ms.set_associations(
            m2, kc, torch.clamp(idx2, min=0),
            torch.arange(L, dtype=torch.int32, device=dev), sel)
    return NewPointsResult(m2, created.sum(), widened)
