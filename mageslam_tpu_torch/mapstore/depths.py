"""Near / far bounding-plane depths of the map points a keyframe sees.

Port of ``mageslam_tpu/mapstore/depths.py`` (BoundingPlaneDepths.h:11-12),
batched: one call takes any number of poses with one point mask each.
"""

from __future__ import annotations

import torch

from mageslam_tpu_torch.config import BoundingDepthSettings
from mageslam_tpu_torch.geometry import se3
from mageslam_tpu_torch.geometry.camera import CameraCalibration, project


def bounding_plane_depths(pose7: torch.Tensor, points: torch.Tensor,
                          point_mask: torch.Tensor, cal: CameraCalibration,
                          settings: BoundingDepthSettings = None):
    """(near, far, any) of the masked points that project inside the ROI,
    for poses (..., 7) and masks (..., L) over points (L, 3).  Softness
    blends the hard minimum / maximum toward the 10th / 90th percentile
    (0, the default, keeps them); without any point the planes are 0.1 and
    10."""
    s = settings if settings is not None else BoundingDepthSettings()
    uv, z = project(cal, se3.pose_apply(pose7[..., None, :], points))
    in_roi = ((uv[..., 0] >= s.roi_min_x * cal.width)
              & (uv[..., 0] <= s.roi_max_x * cal.width)
              & (uv[..., 1] >= s.roi_min_y * cal.height)
              & (uv[..., 1] <= s.roi_max_y * cal.height))
    ok = point_mask & (z > 0) & in_roi
    inf = torch.full_like(z, float("inf"))
    near_hard = torch.amin(torch.where(ok, z, inf), -1)
    far_hard = torch.amax(torch.where(ok, z, -inf), -1)
    zs = torch.where(ok, z, torch.full_like(z, float("nan")))
    near_soft = torch.nanquantile(zs, 0.1, dim=-1)
    far_soft = torch.nanquantile(zs, 0.9, dim=-1)
    near = (1 - s.near_depth_softness) * near_hard \
        + s.near_depth_softness * near_soft
    far = (1 - s.far_depth_softness) * far_hard \
        + s.far_depth_softness * far_soft
    any_ok = ok.any(-1)
    return (torch.where(any_ok, near, torch.full_like(near, 0.1)),
            torch.where(any_ok, far, torch.full_like(far, 10.0)), any_ok)
