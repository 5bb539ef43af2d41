"""The facade's sensor and fuser plumbing, stereo map seeding, volume of
interest and trajectory queries.

Port of ``mageslam_tpu/runtime/facade_common.py`` (MageSlam.h:156-182:
ProcessStereoFrames, AddSensorSample, gravity / scale queries,
TryGetVolumeOfInterest, GetTrackingResultsForFrames).  The JAX package
shares these between its host and fused facades; the port has the fused
one only.
"""

from __future__ import annotations

import numpy as np
import torch

from mageslam_tpu_torch.fuser.imu import Fuser
from mageslam_tpu_torch.fuser.samples import SensorSampleQueue
from mageslam_tpu_torch.geometry import se3
from mageslam_tpu_torch.mapstore import map_state as ms
from mageslam_tpu_torch.mapstore import pose_history as ph
from mageslam_tpu_torch.mapstore.depths import bounding_plane_depths
from mageslam_tpu_torch.mapstore.volume_of_interest import \
    compute_volume_of_interest
from mageslam_tpu_torch.ops import util
from mageslam_tpu_torch.runtime.results import TrackingResult, TrackingState


class SensorFacadeMixin:
    """AddSensorSample, the gravity / scale queries and the fuser's mode
    machine glue (FuserWorker.cpp:44-142).  Requires ``self.settings``."""

    def add_sensor_sample(self, sample) -> bool:
        """MAGESlam::AddSensorSample (MageSlam.h:164)."""
        if not hasattr(self, "_sensor_queue"):
            self._sensor_queue = SensorSampleQueue(
                drop_mag=self.settings.fuser.drop_mag_samples)
            self._fuser = Fuser()
        return self._sensor_queue.add_sample(sample)

    def get_gravity_direction(self):
        """Unit gravity in the map frame once converged (MageSlam.h:168)."""
        if hasattr(self, "_fuser") and self._fuser.has_gravity:
            g = self._fuser.gravity_w
            return g / max(np.linalg.norm(g), 1e-9)
        return None

    def get_scale(self):
        """Metric scale estimate once converged (MageSlam.h:172)."""
        if hasattr(self, "_fuser"):
            return self._fuser.scale
        return None

    def _drive_fuser(self, ts, result):
        """Drain the samples up to this frame and step the fuser; active
        once samples were added and ``use_fuser`` is set."""
        if not hasattr(self, "_sensor_queue") or \
                not self.settings.fuser.use_fuser:
            return
        samples = self._sensor_queue.drain_until(ts)
        accel, gyro = self._sensor_queue.split_by_type(samples)
        if result.state == TrackingState.TRACKING:
            self._fuser.on_mage_initialized()
            self._fuser.on_visual_reacquired()
            self._fuser.process_fence(accel, gyro, result.pose)
        elif result.state == TrackingState.RELOCALIZING:
            self._fuser.on_visual_lost()
            self._fuser.process_fence(accel, gyro, None)
        else:
            self._fuser.process_fence(accel, gyro, None)


def seed_map_from_stereo(m: ms.MapState, history, f1, f2, res, extrinsics,
                         fid: int, ts: float, scale_factor: float = 1.5):
    """A metric map from a stereo initialization: keyframe 0 is camera 1 at
    identity, keyframe 1 camera 2 at the rig extrinsics, both immortal.
    Returns (map, history, slot0, slot1)."""
    F = f1.valid.shape[0]
    dev = res.points.device
    d0 = torch.linalg.vector_norm(res.points, dim=-1)
    normal = res.points / torch.clamp(d0, min=1e-9)[:, None]
    m, mp_ids = ms.allocate_map_points(
        m, res.points, f1.desc, normal, 0, res.point_valid,
        octave=f1.octave,
        max_dist=d0 * scale_factor ** f1.octave.to(torch.float32))
    created = mp_ids >= 0
    none = torch.full_like(mp_ids, -1)
    assoc1 = torch.where(created, mp_ids, none)
    ident = se3.pose_identity(dev)
    m, s0 = ms.insert_keyframe(m, ident, f1, assoc1, fid, immortal=True)
    feat2 = torch.clamp(res.match_idx, min=0)
    tgt = torch.where(created & (res.match_idx >= 0), feat2,
                      torch.full_like(feat2, F))
    assoc2 = util.scatter_set_last(
        torch.full((F + 1,), -1, dtype=torch.int32, device=dev), tgt,
        torch.where(created, mp_ids, none))[:F]
    extr = torch.as_tensor(np.asarray(extrinsics, np.float32), device=dev)
    m, s1 = ms.insert_keyframe(m, extr, f2, assoc2, fid, immortal=True)
    history = ph.add_pose(history, fid, ts, ident,
                          torch.stack([s0, s1]).to(torch.int32), m.kf_pose)
    return m, history, s0, s1


def volume_of_interest_from_map(m: ms.MapState, cal, settings):
    """MAGESlam::TryGetVolumeOfInterest (MageSlam.h:178) over a map: the
    bounding planes of every valid keyframe in one batched call, then the
    voxel passes on the map's device."""
    idx = torch.nonzero(m.kf_valid).flatten()
    if idx.numel() < 2:
        return None
    poses = m.kf_pose[idx]
    near, far, ok = bounding_plane_depths(
        poses, m.mp_pos, ms.member_matrix(m)[idx], cal,
        settings.bounding_depth)
    voi = compute_volume_of_interest(
        poses.cpu().numpy(), near.cpu().numpy(), far.cpu().numpy(),
        ok.cpu().numpy(), settings.volume_of_interest,
        device=m.kf_pose.device)
    return voi if voi.valid else None


def tracking_results_from_history(history, kf_pose, kf_valid, results: dict,
                                  frame_ids):
    """MAGESlam::GetTrackingResultsForFrames: per-frame poses re-read from
    the pose history, so they reflect all later optimization (bundle
    adjustment, loop closure)."""
    poses, ok = ph.world_poses(history, kf_pose, kf_valid)
    poses = poses.cpu().numpy()
    ok = ok.cpu().numpy()
    hist_fid = history.frame_id.cpu().numpy()
    out = []
    for fid in frame_ids:
        match = np.nonzero(ok & (hist_fid == fid))[0]
        r = results.get(fid)
        if len(match):
            out.append(TrackingResult(
                fid, r.timestamp if r else fid / 30.0,
                TrackingState.TRACKING, poses[match[0]]))
        else:
            out.append(r if r is not None else TrackingResult(
                fid, fid / 30.0, TrackingState.SKIPPED))
    return out
