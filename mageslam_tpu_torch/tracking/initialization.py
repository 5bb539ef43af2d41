"""Monocular map initialization: two-view bootstrap.

Port of ``mageslam_tpu/tracking/initialization.py``: octave-0 matching,
dual essential/homography RANSAC scored against each other,
triangulation with reprojection / distance / median-depth gates, init BA
with the first view fixed, pose-change sanity check.  The RANSAC draws are
an explicit argument (``InitDraws``): the engine samples them from its
``torch.Generator`` with ``sample_init_draws``; the parity tests pass the
JAX package's own draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mageslam_tpu_torch.config import MonoMapInitializationSettings
from mageslam_tpu_torch.geometry import se3, triangulation
from mageslam_tpu_torch.ops import matching, util
from mageslam_tpu_torch.solvers import essential, homography, sampling
from mageslam_tpu_torch.solvers.bundle_adjust import (BAProblem,
                                                      bundle_adjust,
                                                      empty_tethers)
from mageslam_tpu_torch.tracking.frontend import FrameFeatures

E_HYPOTHESES = 1024
H_HYPOTHESES = 512


class InitResult(NamedTuple):
    success: torch.Tensor
    pose1: torch.Tensor
    points: torch.Tensor
    point_valid: torch.Tensor
    match_idx: torch.Tensor
    num_points: torch.Tensor
    num_matches: torch.Tensor
    mean_sq_error: torch.Tensor
    used_homography: torch.Tensor


class InitDraws(NamedTuple):
    """Minimal-set indices: essential 8-point (H, 8) and 5-point (H5, 5)
    pools, homography 4-point (HH, 4)."""

    e8: torch.Tensor
    e5: torch.Tensor
    h4: torch.Tensor


def _match(f0: FrameFeatures, f1: FrameFeatures,
           s: MonoMapInitializationSettings):
    oct0_a = f0.valid & (f0.octave == 0)
    oct0_b = f1.valid & (f1.octave == 0)
    return matching.match(
        f0.desc, f1.desc, oct0_a, oct0_b,
        max_distance=s.five_point_matching.max_hamming_distance,
        min_difference=s.five_point_matching.min_hamming_difference)


def sampling_weights(f0, f1, s):
    """(valid matches, sampling probability) the RANSAC draws use."""
    idx, dist = _match(f0, f1, s)
    matched = idx >= 0
    weight = torch.exp(-dist.to(torch.float32) / 12.0)
    return matched, sampling.sampling_probs(matched, weight)


def sample_init_draws(gen: torch.Generator, f0, f1,
                      s: MonoMapInitializationSettings) -> InitDraws:
    return draw_init(sampling.generator_sampler(gen), f0, f1, s)


def draw_init(sampler, f0, f1, s: MonoMapInitializationSettings
              ) -> InitDraws:
    """The attempt's minimal sets through ``sampler(p, num, k)``
    (``solvers/sampling.py``): the 8-point pool, the 5-point pool, then
    the homography's 4-point sets."""
    _, p = sampling_weights(f0, f1, s)
    return InitDraws(
        sampler(p, E_HYPOTHESES, 8),
        sampler(p, essential.num_five_point(E_HYPOTHESES), 5),
        sampler(p, H_HYPOTHESES, 4))


def attempt_initialization(draws: InitDraws, f0: FrameFeatures,
                           f1: FrameFeatures,
                           settings: MonoMapInitializationSettings,
                           fx: float) -> InitResult:
    F = f0.valid.shape[0]
    s = settings
    dev = f0.uv.device
    px = 1.0 / fx
    idx, dist = _match(f0, f1, s)
    matched = idx >= 0
    n_matches = matched.sum()
    xn0 = f0.xn_undist
    xn1 = f1.xn_undist[torch.clamp(idx, min=0).long()]
    thr = float(torch.tensor(s.fundamental_transfer_error_threshold * px,
                             dtype=torch.float32))
    spread = float(torch.tensor(s.min_pixel_spread * px,
                                dtype=torch.float32))
    eres = essential.essential_ransac_from_samples(
        xn0, xn1, matched, thr, spread, draws.e8, draws.e5)
    hres = homography.homography_ransac_from_samples(
        xn0, xn1, matched, thr, spread, draws.h4)
    r_h = hres.score / torch.clamp(hres.score + eres.score, min=1e-12)
    use_h = r_h > s.homography_model_ratio
    pose_h = homography.recover_pose_from_h(hres.H, xn0, xn1, hres.inliers)
    pose1 = torch.where(use_h, pose_h, eres.rel_pose)
    inl = torch.where(use_h, hres.inliers, eres.inliers)
    model_inliers = torch.where(use_h, hres.num_inliers, eres.num_inliers)

    ones = torch.ones((F, 1), dtype=torch.float32, device=dev)
    pose0 = se3.pose_identity(dev)
    X, tri_ok = triangulation.triangulate_midpoint(
        pose0, pose1, torch.cat([xn0, ones], -1), torch.cat([xn1, ones], -1))
    z0 = X[:, 2]
    y1 = se3.pose_apply(pose1, X)
    z1 = y1[:, 2]

    def sd(v, z):
        return v / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9),
                               z)[:, None]

    lim = (s.max_epipolar_error * px) ** 2
    reproj_ok = (torch.sum((sd(X[:, :2], z0) - xn0) ** 2, -1) < lim) \
        & (torch.sum((sd(y1[:, :2], z1) - xn1) ** 2, -1) < lim)
    dist_ok = torch.linalg.vector_norm(X, dim=-1) \
        < s.max_parallax_3d_distance
    pt_ok = inl & tri_ok & (z0 > 0) & (z1 > 0) & reproj_ok & dist_ok
    med = util.nanmedian(torch.where(pt_ok, z0,
                                     torch.full_like(z0, float("nan"))),
                         dim=0)
    med_ok = torch.isfinite(med) & (med < s.max_parallax_3d_median_distance)

    problem = BAProblem(
        kf_poses=torch.stack([pose0, pose1]),
        kf_fixed=torch.arange(2, device=dev) == 0,
        points=X, point_valid=pt_ok,
        obs_kf=torch.arange(2, dtype=torch.int32, device=dev).expand(F, 2)
        .clone(),
        obs_xn=torch.stack([xn0, xn1], 1),
        obs_valid=torch.stack([pt_ok, pt_ok], 1),
        **empty_tethers(0, dev))
    hd = float(torch.tensor(s.final_ba_huber_width * px, dtype=torch.float32))
    moe = float(torch.tensor(s.final_ba_max_outlier_error * px,
                             dtype=torch.float32))
    bares = bundle_adjust(problem, hd, moe, num_steps=s.final_ba_num_steps)
    pose1_ba = bares.kf_poses[1]
    pt_ok = pt_ok & ~(bares.outliers[:, 0] | bares.outliers[:, 1])
    dpose = se3.pose_log(se3.pose_compose(pose1_ba, se3.pose_inverse(pose1)))
    pose_ok = torch.linalg.vector_norm(dpose) < s.amount_ba_can_change_pose
    n_points = pt_ok.sum()
    success = ((n_matches >= s.min_feature_matches)
               & (model_inliers >= s.min_scoring_inliers)
               & (model_inliers
                  >= s.min_inlier_percentage * torch.clamp(n_matches, min=1))
               & med_ok & (n_points >= s.min_initial_map_points) & pose_ok)
    return InitResult(
        success=success, pose1=pose1_ba, points=bares.points,
        point_valid=pt_ok,
        match_idx=torch.where(pt_ok, idx, torch.full_like(idx, -1)),
        num_points=n_points, num_matches=n_matches,
        mean_sq_error=bares.mean_sq_error, used_homography=use_h)
