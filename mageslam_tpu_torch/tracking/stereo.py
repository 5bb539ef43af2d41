"""Stereo map initialization from a calibrated pair.

Port of ``mageslam_tpu/tracking/stereo.py``: match the pair, gate the
matches against the essential matrix of the known extrinsics, triangulate
by midpoints, keep points in front of both cameras within the depth and
baseline-ratio gates, then bundle-adjust the pair with an EXTRINSIC tether
over ``4 * num_steps + 4`` LM steps.  The baseline is known, so the map is
metric.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mageslam_tpu_torch.config import StereoMapInitializationSettings
from mageslam_tpu_torch.geometry import epipolar, se3, triangulation
from mageslam_tpu_torch.ops import matching
from mageslam_tpu_torch.solvers.bundle_adjust import (BAProblem,
                                                      TETHER_EXTRINSIC,
                                                      bundle_adjust)
from mageslam_tpu_torch.tracking.frontend import FrameFeatures


class StereoInitResult(NamedTuple):
    success: torch.Tensor
    points: torch.Tensor        # (F, 3) world (= camera-1) frame
    point_valid: torch.Tensor   # (F,)
    match_idx: torch.Tensor     # (F,) feature in frame 2 or -1
    num_points: torch.Tensor
    mean_sq_error: torch.Tensor


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


def stereo_initialize(f1: FrameFeatures, f2: FrameFeatures,
                      extrinsics: torch.Tensor,
                      settings: StereoMapInitializationSettings,
                      fx: float) -> StereoInitResult:
    """Bootstrap a metric map from one stereo pair; ``extrinsics`` (7,) maps
    camera-1 coordinates to camera-2 coordinates (x2 = R x1 + t)."""
    s = settings
    dev = f1.uv.device
    px = 1.0 / fx
    F = f1.valid.shape[0]
    extrinsics = extrinsics.to(device=dev, dtype=torch.float32)

    idx, _ = matching.match(
        f1.desc, f2.desc, f1.valid, f2.valid,
        max_distance=s.matcher.max_hamming_distance,
        min_difference=s.matcher.min_hamming_difference)
    matched = idx >= 0
    n_matches = matched.sum()

    xn1 = f1.xn_undist
    xn2 = f2.xn_undist[torch.clamp(idx, min=0).long()]
    E = epipolar.essential_from_pose(extrinsics)
    epi = epipolar.symmetric_epipolar_distance_sq(E, xn1, xn2)
    epi_ok = epi < (s.max_epipolar_error * px) ** 2

    pose1 = se3.pose_identity(dev)
    ones = torch.ones((F, 1), dtype=torch.float32, device=dev)
    X, tri_ok = triangulation.triangulate_midpoint(
        pose1, extrinsics, torch.cat([xn1, ones], -1),
        torch.cat([xn2, ones], -1))
    z1 = X[:, 2]
    z2 = se3.pose_apply(extrinsics, X)[:, 2]
    depth_ok = (z1 > 0) & (z2 > 0) & (z1 < s.max_depth_meters)
    baseline = torch.linalg.vector_norm(se3.pose_t(extrinsics))
    ratio_ok = (torch.linalg.vector_norm(X, dim=-1)
                / torch.clamp(baseline, min=1e-9)) \
        > s.min_accepted_distance_ratio
    pt_ok = matched & epi_ok & tri_ok & depth_ok & ratio_ok

    i32 = dict(dtype=torch.int32, device=dev)
    problem = BAProblem(
        kf_poses=torch.stack([pose1, extrinsics]),
        kf_fixed=torch.tensor([True, False], device=dev),
        points=X, point_valid=pt_ok,
        obs_kf=torch.arange(2, **i32)[None].expand(F, 2).contiguous(),
        obs_xn=torch.stack([xn1, xn2], 1),
        obs_valid=torch.stack([pt_ok, pt_ok], 1),
        tether_i=torch.tensor([1], **i32),
        tether_j=torch.tensor([0], **i32),
        tether_type=torch.tensor([TETHER_EXTRINSIC], **i32),
        tether_pose=extrinsics[None],
        tether_dist=torch.zeros(1, dtype=torch.float32, device=dev),
        tether_weight=torch.full((1,), s.initialization_tether_strength,
                                 dtype=torch.float32, device=dev))
    bares = bundle_adjust(
        problem, _f32(s.bundle_adjust.huber_width * px),
        _f32(s.max_outlier_error * px),
        num_steps=int(s.bundle_adjust.num_steps) * 4 + 4)
    pt_ok = pt_ok & ~(bares.outliers[:, 0] | bares.outliers[:, 1])
    n_points = pt_ok.sum()
    success = (n_matches >= s.min_feature_matches) \
        & (n_points >= s.min_init_map_points)
    return StereoInitResult(
        success=success, points=bares.points, point_valid=pt_ok,
        match_idx=torch.where(pt_ok, idx, torch.full_like(idx, -1)),
        num_points=n_points, mean_sq_error=bares.mean_sq_error)
