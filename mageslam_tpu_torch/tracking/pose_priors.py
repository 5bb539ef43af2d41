"""Pose prior providers: the motion model and the IMU.

Port of ``mageslam_tpu/tracking/pose_priors.py``.  A provider is a host
object consulted once per frame (``get_pose_for_time``) and told each
tracked pose (``on_tracking_pose``); the (7,) view pose it returns goes to
``DeviceEngine.step(..., ext_prior=...)``, where it replaces the engine's
constant-velocity extrapolation.  Providers compute on the host with the
port's ``geometry/se3.py`` on float32 CPU tensors and return numpy arrays.

- ``MotionModelPriorProvider``: constant velocity, scaled by the ratio of
  time steps (MotionModelPriorProvider.cpp:13-17).
- ``IMUPosePriorProvider``: the gyro-integrated rotation since the last
  tracked pose composed onto it; translation held (UnfilteredIMU.h).
"""

from __future__ import annotations

from typing import Optional, Protocol

import numpy as np
import torch

from mageslam_tpu_torch.fuser.imu import UnfilteredIMU
from mageslam_tpu_torch.geometry import se3


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


class IPosePriorProvider(Protocol):
    def get_pose_for_time(self, timestamp: float) -> Optional[np.ndarray]:
        """Predicted (7,) view pose for the time, or None."""

    def on_tracking_pose(self, timestamp: float, pose) -> None:
        """Observe a confirmed tracked pose (PoseRefined event)."""


class MotionModelPriorProvider:
    """The relative motion of the last two tracked poses, scaled by the
    ratio of time steps and applied forward."""

    def __init__(self):
        self._t1: Optional[float] = None
        self._t2: Optional[float] = None
        self._p1: Optional[torch.Tensor] = None   # most recent
        self._p2: Optional[torch.Tensor] = None

    def on_tracking_pose(self, timestamp: float, pose) -> None:
        self._t2, self._p2 = self._t1, self._p1
        self._t1, self._p1 = float(timestamp), _t(pose)

    def get_pose_for_time(self, timestamp: float) -> Optional[np.ndarray]:
        if self._p1 is None:
            return None
        if self._p2 is None or self._t1 == self._t2:
            return self._p1.numpy()
        steps = (float(timestamp) - self._t1) / (self._t1 - self._t2)
        return se3.constant_velocity_extrapolate(
            self._p2, self._p1, steps=max(steps, 0.0)).numpy()

    def reset(self):
        self.__init__()


class IMUPosePriorProvider:
    """Gyro-integrated rotation on top of the last tracked pose; the
    translation is held (double-integrated accel is unusable without a
    filter, and the reference stubs that path too)."""

    def __init__(self, body_to_camera: Optional[np.ndarray] = None):
        self._imu = UnfilteredIMU()
        self._gyro_buf: list = []     # [(t, wx, wy, wz)] since last fence
        self._anchor_pose: Optional[torch.Tensor] = None
        self._q_at_anchor = np.array([1.0, 0, 0, 0], np.float32)
        self._r_bc = (np.eye(3, dtype=np.float32)
                      if body_to_camera is None
                      else np.asarray(body_to_camera,
                                      np.float32)[:3, :3])

    def add_sample(self, timestamp: float, gyro_xyz) -> None:
        self._gyro_buf.append((float(timestamp), *map(float, gyro_xyz)))

    def _integrate_pending(self):
        if len(self._gyro_buf) >= 2:
            self._imu.step(np.zeros((0, 4), np.float32),
                           np.asarray(self._gyro_buf, np.float32))
            self._gyro_buf = self._gyro_buf[-1:]

    def on_tracking_pose(self, timestamp: float, pose) -> None:
        self._integrate_pending()
        self._anchor_pose = _t(pose)
        self._q_at_anchor = np.array(self._imu.q_wb, np.float32)

    def get_pose_for_time(self, timestamp: float) -> Optional[np.ndarray]:
        if self._anchor_pose is None:
            return None
        self._integrate_pending()
        dq_body = se3.quat_mul(se3.quat_conj(_t(self._q_at_anchor)),
                               _t(self._imu.q_wb))
        r_bc = _t(self._r_bc)
        dq_cam = se3.mat_to_quat(r_bc @ se3.quat_to_mat(dq_body) @ r_bc.T)
        # a body rotation dq right-composes the inverse camera delta onto
        # the view pose
        q_new = se3.quat_mul(se3.quat_conj(dq_cam),
                             se3.pose_q(self._anchor_pose))
        return se3.make_pose(q_new, se3.pose_t(self._anchor_pose)).numpy()
