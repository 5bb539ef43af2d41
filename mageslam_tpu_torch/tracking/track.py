"""Per-frame tracking: prior -> project -> match -> optimize.

Port of ``mageslam_tpu/tracking/track.py``: local map from the reference
keyframe's covisibility, candidate gates, compaction to at most
``track_candidates`` rows (ranked by local observation count, then slot),
three widening radius-match rounds, two-stage pose refinement, and the
reference/anchor keyframes for the pose history.  With several pyramid
levels a scale-invariance distance gate joins the candidate gates and the
search radii widen by the predicted level's scale.  Tracking draws nothing
at random.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mageslam_tpu_torch.config import MageSlamSettings
from mageslam_tpu_torch.geometry import se3
from mageslam_tpu_torch.geometry.camera import CameraCalibration, project
from mageslam_tpu_torch.mapstore import map_state as ms
from mageslam_tpu_torch.mapstore import pose_history as ph
from mageslam_tpu_torch.ops import matching, util
from mageslam_tpu_torch.solvers import pnp
from mageslam_tpu_torch.tracking.frontend import FrameFeatures
from mageslam_tpu_torch.utils.tracing import PROFILER


class TrackResult(NamedTuple):
    pose: torch.Tensor
    success: torch.Tensor
    assoc: torch.Tensor
    num_matched: torch.Tensor
    num_inliers: torch.Tensor
    mean_sq_error: torch.Tensor
    local_mp_mask: torch.Tensor
    found_mp_mask: torch.Tensor
    ref_kf: torch.Tensor
    anchor_kf: torch.Tensor
    anchor_ok: torch.Tensor


def _scaled_f32(w: float, px32: torch.Tensor) -> float:
    """``w * px`` in float32, as the JAX step computes it from the traced
    float32 calibration."""
    return float(torch.tensor(w, dtype=torch.float32) * px32)


def cos_deg_f32(deg: float) -> float:
    """``jnp.cos(jnp.deg2rad(deg))`` evaluated in float32."""
    return float(torch.cos(torch.deg2rad(torch.tensor(deg,
                                                      dtype=torch.float32))))


def _in_image(uv, cal):
    return ((uv[:, 0] >= 0) & (uv[:, 0] <= cal.width - 1)
            & (uv[:, 1] >= 0) & (uv[:, 1] <= cal.height - 1))


def scale_gate(mp_pos, mp_max_dist, cam_center, num_levels: int,
               sf: float) -> torch.Tensor:
    """Scale-invariance distance gate (IsGoodCandidate): a point created at
    octave o and distance d is expected visible between
    ``0.8 * d_max / sf**(levels-1)`` and ``1.25 * d_max``, d_max = d * sf**o;
    points without scale information (``mp_max_dist <= 0``) pass."""
    dist = torch.linalg.vector_norm(mp_pos - cam_center, dim=-1)
    dmax = mp_max_dist * 1.25
    dmin = mp_max_dist / (sf ** (num_levels - 1)) * 0.8
    return (mp_max_dist <= 0) | ((dist >= dmin) & (dist <= dmax))


def search_radius_scale(pos_c, max_dist_c, cam_center, num_levels: int,
                        sf: float) -> torch.Tensor:
    """``sf**level`` of the level each candidate is predicted to be seen
    at from its distance (1 for points without scale information): a
    coarse-level keypoint localizes that much worse in level-0 pixels."""
    dist = torch.linalg.vector_norm(pos_c - cam_center, dim=-1)
    ratio = max_dist_c / torch.clamp(dist, min=1e-6)
    oct_pred = torch.clamp(
        torch.round(torch.log(torch.clamp(ratio, min=1e-6))
                    / torch.log(torch.tensor(sf, dtype=torch.float32))),
        0.0, float(num_levels - 1))
    return torch.where(max_dist_c > 0, sf ** oct_pred,
                       torch.ones_like(oct_pred))


def track_frame(m: ms.MapState, feats: FrameFeatures, prior_pose, last_kf,
                cal: CameraCalibration, settings: MageSlamSettings,
                max_local_kf: int = 16) -> TrackResult:
    s = settings
    K, F, L = ms.capacities(m)
    dev = m.kf_pose.device
    px32 = torch.tensor(1.0, dtype=torch.float32) \
        / torch.tensor(cal.fx, dtype=torch.float32)
    fe = s.mono.camera.features
    num_levels = int(fe.num_levels)
    sf = float(fe.scale_factor)
    last = util.full(last_kf, dev, torch.int32)
    tl = s.track_local_map

    with PROFILER.scope("tracking.local_map"):
        mem = ms.member_matrix(m)
        cov = ms.covisibility(m)
        kf_idx, kf_ok = ms.connected_keyframes(
            m, last.long(), min_shared=1, max_connected=max_local_kf - 1,
            cov=cov)
        kf_list = torch.cat([last[None], kf_idx])
        kf_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           kf_ok])
        local_mp = ms.local_map_points(m, kf_list, kf_ok, mem=mem)

        uv_pred, z_pred = project(cal, se3.pose_apply(prior_pose[None],
                                                      m.mp_pos))
        in_img = _in_image(uv_pred, cal)
        cam_center = se3.camera_center(prior_pose)
        view_dir = m.mp_pos - cam_center
        view_dir = view_dir / torch.clamp(torch.linalg.vector_norm(
            view_dir, dim=-1, keepdim=True), min=1e-9)
        cos_view = torch.sum(view_dir * m.mp_normal, -1)
        has_normal = torch.linalg.vector_norm(m.mp_normal, dim=-1) > 0.5
        cos_min = cos_deg_f32(
            tl.min_degrees_between_current_view_and_map_point_view)
        angle_ok = ~has_normal | (cos_view > cos_min)
        candidates = local_mp & (z_pred > 0) & in_img & angle_ok
        if num_levels > 1:
            candidates = candidates & scale_gate(m.mp_pos, m.mp_max_dist,
                                                 cam_center, num_levels, sf)

        # compaction: keep the C best-covisible candidates, then back to
        # ascending slot order
        C = min(s.capacity.track_candidates, L)
        obs_count = (mem[kf_list.long()] & kf_ok[:, None]).sum(0)
        ar = torch.arange(L, device=dev)
        sel_score = torch.where(candidates, obs_count * (L + 1) + (L - ar),
                                torch.zeros_like(ar))
        svals, cidx = util.topk(sel_score, C)
        c_valid = svals > 0
        cidx = torch.sort(torch.where(c_valid, cidx,
                                      torch.full_like(cidx, L))).values
        c_valid = cidx < L
        cidx = torch.clamp(cidx, 0, L - 1)
        pos_c = m.mp_pos[cidx]
        desc_c = m.mp_desc[cidx]
        uv_pred_c = uv_pred[cidx]
        rad_scale = (search_radius_scale(pos_c, m.mp_max_dist[cidx],
                                         cam_center, num_levels, sf)
                     if num_levels > 1 else None)

    pe = s.pose_estimation
    ham = tl.matcher.max_hamming_distance

    def radius(px: float):
        # per candidate with several levels, else one Python radius
        if rad_scale is None:
            return float(px)
        return torch.tensor(px, dtype=torch.float32) * rad_scale

    def match_round(radius_px):
        idx, dist = matching.radius_match(
            uv_pred_c, desc_c, c_valid, feats.uv, feats.desc, feats.valid,
            radius=radius(radius_px), max_distance=ham,
            min_difference=tl.matcher.min_hamming_difference)
        return matching.assign_unique(idx, dist)

    with PROFILER.scope("tracking.match"):
        mp2feat = match_round(pe.search_radius)
        n1 = (mp2feat >= 0).sum()
        mp2feat = torch.where(n1 < pe.feature_match_threshold,
                              match_round(pe.wider_search_radius), mp2feat)
        n2 = (mp2feat >= 0).sum()
        mp2feat = torch.where(n2 < tl.min_tracked_feature_count,
                              match_round(pe.extra_wider_search_radius),
                              mp2feat)

    with PROFILER.scope("tracking.refine"):
        matched = mp2feat >= 0
        obs_xn = feats.xn_undist[torch.clamp(mp2feat, min=0).long()]
        res1 = pnp.refine_pose(
            prior_pose, pos_c, obs_xn, matched,
            huber_delta=_scaled_f32(tl.initial_pose_ba_huber_width, px32),
            outlier_thresh=_scaled_f32(tl.max_outlier_error_pose_estimation,
                                       px32),
            iters=6)

    with PROFILER.scope("tracking.match"):
        uv_pred2, z_pred2 = project(cal, se3.pose_apply(res1.pose[None],
                                                        pos_c))
        candidates2 = c_valid & (z_pred2 > 0) & _in_image(uv_pred2, cal)
        idx2, dist2 = matching.radius_match(
            uv_pred2, desc_c, candidates2, feats.uv, feats.desc, feats.valid,
            radius=radius(tl.match_search_radius), max_distance=ham,
            min_difference=tl.matcher.min_hamming_difference)
        idx2 = matching.assign_unique(idx2, dist2)
        keep1 = matched & res1.inliers
        mp2feat = torch.where(keep1, mp2feat,
                              torch.where(idx2 >= 0, idx2,
                                          torch.full_like(idx2, -1)))

    with PROFILER.scope("tracking.refine"):
        matched = mp2feat >= 0
        obs_xn = feats.xn_undist[torch.clamp(mp2feat, min=0).long()]
        res2 = pnp.refine_pose(
            res1.pose, pos_c, obs_xn, matched,
            huber_delta=_scaled_f32(tl.ba_huber_width, px32),
            outlier_thresh=_scaled_f32(tl.max_outlier_error, px32), iters=6)

    inlier_c = matched & res2.inliers
    inlier_mp = torch.zeros(L + 1, dtype=torch.bool, device=dev)
    inlier_mp[torch.where(inlier_c, cidx, torch.full_like(cidx, L))] = True
    inlier_mp = inlier_mp[:L]
    feat_safe = torch.where(inlier_c, mp2feat, torch.full_like(mp2feat, F))
    assoc = util.scatter_set_last(
        torch.full((F + 1,), -1, dtype=torch.int32, device=dev), feat_safe,
        torch.where(inlier_c, cidx.to(torch.int32),
                    torch.full_like(cidx, -1, dtype=torch.int32)))[:F]

    shared = (mem & inlier_mp[None, :]).sum(1)
    shared = torch.where(m.kf_valid, shared, torch.full_like(shared, -1))
    ref_kf = torch.argmax(shared).to(torch.int32)
    top_shared, top_kf = util.topk(shared, ph.N_ANCHORS)
    n_inl = inlier_mp.sum()
    return TrackResult(
        pose=res2.pose, success=n_inl >= tl.min_tracked_feature_count,
        assoc=assoc, num_matched=matched.sum(), num_inliers=n_inl,
        mean_sq_error=res2.mean_sq_error, local_mp_mask=candidates,
        found_mp_mask=inlier_mp, ref_kf=ref_kf,
        anchor_kf=top_kf.to(torch.int32), anchor_ok=top_shared > 0)
