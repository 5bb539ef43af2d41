"""Volume of interest: the observed scene's bounding box.

Port of ``mageslam_tpu/mapstore/volume_of_interest.py``
(VolumeOfInterest.h:15-34): each keyframe contributes a "teardrop" score
over a voxel grid, strongest on its view axis between its near and far
planes; the grid is thresholded and the box refined over a few passes of
rising resolution.  ``score_grid`` scores every voxel against every frame
in one (N, V) computation on the device (the JAX package ``vmap``s it);
each pass reads the scores back to cut the box.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mageslam_tpu_torch.config import VolumeOfInterestSettings
from mageslam_tpu_torch.geometry import se3
from mageslam_tpu_torch.runtime.devices import resolve_device


class VolumeOfInterest(NamedTuple):
    min_corner: np.ndarray
    max_corner: np.ndarray
    valid: bool


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _teardrop_score(voxels: torch.Tensor, pose7: torch.Tensor,
                    near: torch.Tensor, far: torch.Tensor,
                    s: VolumeOfInterestSettings) -> torch.Tensor:
    """(N, V) score of each voxel under each frame's teardrop: maximal on
    the view axis within [near, far], falling off away from the axis
    (side prominence) and along it (away / toward prominence)."""
    y = se3.pose_apply(pose7[:, None, :], voxels[None])   # (N, V, 3)
    z = y[..., 2]
    r = torch.linalg.vector_norm(y[..., :2], dim=-1)
    near, far = near[:, None], far[:, None]
    depth_range = torch.clamp(far - near, min=1e-3)
    mid = 0.5 * (near + far)
    ahead = (z - mid) / depth_range
    axial = torch.where(
        ahead >= 0,
        torch.exp(-0.5 * (ahead / max(s.away_prominence, 1e-3)) ** 2),
        torch.exp(-0.5 * (ahead / max(s.toward_prominence, 1e-3)) ** 2))
    half_w = torch.tan(_f32(s.kernel_angle_x_rads / 2)).to(z.device) \
        * torch.clamp(z, min=1e-3)
    lateral = torch.exp(
        -0.5 * (r / torch.clamp(half_w * s.side_prominence, min=1e-3)) ** 2)
    return torch.where(z > 0, axial * lateral, torch.zeros_like(z))


def score_grid(min_c: torch.Tensor, max_c: torch.Tensor, poses, nears, fars,
               frame_valid, settings: VolumeOfInterestSettings,
               grid: int = 24):
    """(grid^3,) mean teardrop score over the valid frames, and the voxel
    centres (grid^3, 3)."""
    dev = poses.device
    gs = torch.linspace(0.0, 1.0, grid, device=dev)
    gx, gy, gz = torch.meshgrid(gs, gs, gs, indexing="ij")
    unit = torch.stack([gx, gy, gz], -1).reshape(-1, 3)
    voxels = min_c + unit * (max_c - min_c)
    scores = _teardrop_score(voxels, poses, nears, fars, settings) \
        * frame_valid.to(torch.float32)[:, None]
    return (torch.sum(scores, 0)
            / torch.clamp(frame_valid.sum(), min=1).to(torch.float32),
            voxels)


def compute_volume_of_interest(poses: np.ndarray, nears: np.ndarray,
                               fars: np.ndarray, valid: np.ndarray,
                               settings: VolumeOfInterestSettings = None,
                               device=None) -> VolumeOfInterest:
    """The high-interest box, refined over ``settings.iterations`` passes
    of the voxel grid; ``device`` is where the grid is scored: the CUDA
    card unless the caller names another, and a raise without one."""
    s = settings if settings is not None else VolumeOfInterestSettings()
    dev = resolve_device(device)
    if valid.sum() == 0:
        return VolumeOfInterest(np.zeros(3), np.zeros(3), False)
    poses_t = torch.as_tensor(np.asarray(poses, np.float32), device=dev)
    centers = se3.camera_center(poses_t)
    fwd = se3.quat_rotate(se3.quat_conj(se3.pose_q(poses_t)),
                          torch.tensor([0.0, 0.0, 1.0], device=dev)
                          .expand_as(centers))
    centers, fwd = centers.cpu().numpy(), fwd.cpu().numpy()
    reach = np.maximum(np.asarray(fars), 1.0)[:, None]
    pts = np.concatenate([centers, centers + fwd * reach])
    min_c = pts.min(0) - 1.0
    max_c = pts.max(0) + 1.0

    nears_t = torch.as_tensor(np.asarray(nears, np.float32), device=dev)
    fars_t = torch.as_tensor(np.asarray(fars, np.float32), device=dev)
    valid_t = torch.as_tensor(np.asarray(valid), device=dev)
    grid = max(int(round(s.voxel_count_floor ** (1 / 3))), 8)
    for _ in range(max(int(s.iterations), 1)):
        scores, voxels = score_grid(
            torch.as_tensor(np.asarray(min_c, np.float32), device=dev),
            torch.as_tensor(np.asarray(max_c, np.float32), device=dev),
            poses_t, nears_t, fars_t, valid_t, s, grid)
        scores = scores.cpu().numpy()
        voxels = voxels.cpu().numpy()
        keep = scores >= s.threshold * max(scores.max(), 1e-9)
        if not keep.any():
            return VolumeOfInterest(min_c, max_c, False)
        sel = voxels[keep]
        span = (max_c - min_c) / (grid - 1)
        min_c = sel.min(0) - span
        max_c = sel.max(0) + span
    return VolumeOfInterest(min_c, max_c, True)
