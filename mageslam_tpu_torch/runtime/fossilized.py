"""FossilizedMap — immutable post-run trajectory and map queries.

Port of ``mageslam_tpu/runtime/fossilized.py``: world poses of every
history entry after the final global BA, map points, keyframes, and the
console's CSV / TUM exports.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mageslam_tpu_torch.geometry import se3
from mageslam_tpu_torch.mapstore import pose_history as ph


def engine_history(engine) -> ph.PoseHistory:
    """The pose history of a host engine or a fused facade."""
    hist = getattr(engine, "_history", None)
    return hist if hist is not None else engine.state.history


@dataclasses.dataclass(frozen=True)
class FossilizedMap:
    frame_ids: np.ndarray
    timestamps: np.ndarray
    poses: np.ndarray           # (N, 7) view poses
    map_points: np.ndarray      # (P, 3)
    keyframe_poses: np.ndarray  # (Q, 7)
    keyframe_frame_ids: np.ndarray

    @staticmethod
    def from_state(m, history) -> "FossilizedMap":
        poses, ok = ph.world_poses(history, m.kf_pose, m.kf_valid)
        ok = ok.cpu().numpy()
        fid = history.frame_id.cpu().numpy()[ok]
        ts = history.timestamp.cpu().numpy()[ok]
        pw = poses.cpu().numpy()[ok]
        order = np.argsort(fid, kind="stable")
        kf_ok = m.kf_valid.cpu().numpy()
        return FossilizedMap(
            frame_ids=fid[order], timestamps=ts[order], poses=pw[order],
            map_points=m.mp_pos.cpu().numpy()[m.mp_valid.cpu().numpy()],
            keyframe_poses=m.kf_pose.cpu().numpy()[kf_ok],
            keyframe_frame_ids=m.kf_frame_id.cpu().numpy()[kf_ok])

    @staticmethod
    def from_engine(engine) -> "FossilizedMap":
        """From either engine as it stands, without the final global BA
        that ``fossilize`` runs: the host engine (``MageSlamTorch``) keeps
        its pose history in ``_history``, the fused facade
        (``MageSlamTorchFused``) in its engine state."""
        return FossilizedMap.from_state(engine.map_state,
                                        engine_history(engine))

    def pose_for_frame(self, frame_id: int) -> Optional[np.ndarray]:
        i = np.searchsorted(self.frame_ids, frame_id)
        if i < len(self.frame_ids) and self.frame_ids[i] == frame_id:
            return self.poses[i]
        return None

    def camera_centers(self) -> np.ndarray:
        """(N, 3) world-frame camera centres."""
        return se3.camera_center(torch.as_tensor(self.poses)).numpy()

    def _camera_to_world(self) -> np.ndarray:
        if not len(self.poses):
            return np.zeros((0, 7), np.float32)
        return se3.pose_inverse(torch.as_tensor(self.poses)).numpy()

    def world_from_camera_mats(self) -> np.ndarray:
        """(N, 4, 4) camera-to-world transforms."""
        return se3.pose_to_mat44(torch.as_tensor(
            self._camera_to_world())).numpy()

    def export_csv(self, path: str):
        """frame id + flattened 4x4 world-from-camera matrix per line."""
        mats = self.world_from_camera_mats()
        with open(path, "w") as f:
            for fid, m44 in zip(self.frame_ids, mats):
                flat = ",".join(f"{v:.9g}" for v in m44.reshape(-1))
                f.write(f"{fid},{flat}\n")

    def export_tum(self, path: str):
        """TUM format: timestamp tx ty tz qx qy qz qw (camera-to-world)."""
        with open(path, "w") as f:
            for ts, inv in zip(self.timestamps, self._camera_to_world()):
                qw, qx, qy, qz, tx, ty, tz = inv
                f.write(f"{ts:.6f} {tx:.9g} {ty:.9g} {tz:.9g} "
                        f"{qx:.9g} {qy:.9g} {qz:.9g} {qw:.9g}\n")
