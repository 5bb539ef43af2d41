"""Keyframe decision gates (host-side scalar logic).

A copy of ``mageslam_tpu/tracking/keyframe_decision.py`` against the port's
``config.KeyframeSettings``; its callers pass host (numpy) arrays.

Equivalent of the reference's NewKeyFrameDecision
(Tracking/NewKeyFrameDecision.cpp:153-202): ORB-SLAM V-E gates plus extras —
frames-since-keyframe cadence, mapping idle override, min/max tracked
points, reference-keyframe overlap, min-motion-vs-scene-depth.  These are a
handful of scalar comparisons on per-frame stats the tracking jit already
produced, so they run on the host (no device round-trips beyond fetching
the stats, which the runtime needs anyway).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from mageslam_tpu_torch.config import KeyframeSettings


@dataclass
class KeyframeDecisionInputs:
    frames_since_keyframe: int
    frames_since_reloc: int
    num_tracked_points: int
    ref_kf_point_count: int      # points observed by the reference keyframe
    num_matches: int
    mapping_idle: bool
    motion_distance: float       # |camera center - ref kf center|
    min_scene_depth: float       # nearest tracked point depth
    densely_connected: bool = True  # tracked-keypoint grid coverage dense


def densely_connected(uv: np.ndarray, tracked_mask: np.ndarray,
                      width: int, height: int, grid_w: int, grid_h: int,
                      min_per_cell: int, allowed_empty_pct: float) -> bool:
    """NewKeyFrameDecision::DenslyConnected (NewKeyFrameDecision.cpp:67-
    114): bin the TRACKED keypoints into a grid; the frame counts as
    densely connected when the fraction of under-filled cells is at most
    allowed_empty_pct (dense coverage => no urgency to map this view)."""
    uv = np.asarray(uv)[np.asarray(tracked_mask)]
    if uv.size == 0:
        return False
    gx = np.clip((uv[:, 0] * grid_w / width).astype(int), 0, grid_w - 1)
    gy = np.clip((uv[:, 1] * grid_h / height).astype(int), 0, grid_h - 1)
    counts = np.zeros((grid_w, grid_h), np.int32)
    np.add.at(counts, (gx, gy), 1)
    empty_pct = np.mean(counts < min_per_cell)
    return bool(empty_pct <= allowed_empty_pct)


def should_add_keyframe(s: KeyframeSettings,
                        x: KeyframeDecisionInputs) -> bool:
    """True when the current frame should be promoted to a keyframe.

    Mirrors NewKeyFrameDecision::IsNewKeyFrame exactly
    (NewKeyFrameDecision.cpp:153-202):
      1. enough frames since the last relocalization,
      2. mapping idle OR enough frames since the last keyframe,
      3. min < tracked points < max,
      4. moved enough relative to the scene OR grid coverage has holes,
      5. tracked < ref_count * max_overlap + min_count (paper V-E overlap).
    """
    if x.frames_since_reloc <= s.min_frame_count_reloc:
        return False
    if not (x.mapping_idle
            or x.frames_since_keyframe > s.min_frame_count):
        return False
    if x.num_tracked_points <= s.min_tracking_point_count:
        return False
    if x.num_tracked_points >= s.max_tracking_point_matches:
        return False
    moved_enough = (x.motion_distance
                    >= s.min_frame_move_to_min_depth_ratio
                    * max(x.min_scene_depth, 1e-6))
    if not moved_enough and x.densely_connected:
        return False
    return x.num_tracked_points < (x.ref_kf_point_count
                                   * s.max_tracking_point_overlap
                                   + s.min_tracking_point_count)
