"""IMU integration and the visual-inertial fusion manager.

Port of ``mageslam_tpu/fuser/imu.py``: ``UnfilteredIMU`` (direct gyro /
accel integration between image fences), ``PoseInterpolator`` and
``Fuser`` with its mode machine (WaitForMageInit -> GravityConverge ->
ScaleInit -> Tracking), gravity from averaged accelerometer samples and
scale from the ratio of inertial to visual displacement.

The arithmetic runs on the host, sample by sample: float32 quaternions
through the port's own ``geometry/se3.py`` on CPU tensors, the rest in
numpy, exactly as the reference computes it (its FuserWorker is a CPU
thread).  Work at the sensor rate is a handful of 4-vectors per sample;
a device round trip per sample would cost more than the arithmetic.
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum
from typing import Optional

import numpy as np
import torch

from mageslam_tpu_torch.geometry import se3

GRAVITY = 9.80665


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


class FuserMode(IntEnum):  # Fuser.h mode machine
    INACTIVE = 0
    WAIT_FOR_MAGE_INIT = 1
    GRAVITY_CONVERGE = 2
    SCALE_INIT = 3
    TRACKING = 4
    VISUAL_TRACKING_LOST = 5


def integrate_gyro(q0: np.ndarray, gyro: np.ndarray) -> np.ndarray:
    """Integrate body-frame gyro samples [(t, wx, wy, wz), ...] from
    orientation q0; returns the final float32 quaternion."""
    q = _t(q0)
    for i in range(len(gyro) - 1):
        dt = float(gyro[i + 1, 0] - gyro[i, 0])
        dq = se3.so3_exp(_t(gyro[i, 1:4]) * dt)
        q = se3.quat_normalize(se3.quat_mul(q, dq))
    return q.numpy()


def integrate_accel(accel: np.ndarray, q_wb: np.ndarray,
                    gravity_w: np.ndarray, v0: np.ndarray):
    """Double-integrate accel samples [(t, ax, ay, az), ...] at a fixed
    body orientation, given world gravity and an initial velocity; returns
    (delta_p, v1) in float64."""
    p = np.zeros(3)
    v = np.asarray(v0, np.float64).copy()
    R = se3.quat_to_mat(_t(q_wb)).numpy()
    for i in range(len(accel) - 1):
        dt = float(accel[i + 1, 0] - accel[i, 0])
        a_w = R @ np.asarray(accel[i, 1:4]) - gravity_w
        p += v * dt + 0.5 * a_w * dt * dt
        v += a_w * dt
    return p, v


@dataclasses.dataclass
class UnfilteredIMU:
    """Direct integrator between image fences (UnfilteredIMU.h:15-25)."""

    q_wb: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 0, 0, 0]))
    v: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    gravity_w: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, -GRAVITY, 0.0]))

    def step(self, accel: np.ndarray, gyro: np.ndarray):
        """Integrate one fence window; returns (delta rotation, delta p)."""
        q0 = self.q_wb.copy()
        if len(gyro) >= 2:
            self.q_wb = integrate_gyro(self.q_wb, gyro)
        dp = np.zeros(3)
        if len(accel) >= 2:
            dp, self.v = integrate_accel(accel, q0, self.gravity_w, self.v)
        dq = se3.quat_mul(se3.quat_conj(_t(q0)), _t(self.q_wb)).numpy()
        return dq, dp


class PoseInterpolator:
    """Pose at arbitrary timestamps from a pose track
    (PoseInterpolator.h:14-24)."""

    def __init__(self):
        self._ts: list[float] = []
        self._poses: list[np.ndarray] = []

    def add(self, timestamp: float, pose7: np.ndarray):
        self._ts.append(timestamp)
        self._poses.append(np.asarray(pose7))

    def pose_at(self, timestamp: float) -> Optional[np.ndarray]:
        if not self._ts:
            return None
        ts = np.asarray(self._ts)
        i = int(np.searchsorted(ts, timestamp))
        if i == 0:
            return self._poses[0]
        if i >= len(ts):
            return self._poses[-1]
        a = (timestamp - ts[i - 1]) / max(ts[i] - ts[i - 1], 1e-9)
        return se3.pose_interpolate(_t(self._poses[i - 1]),
                                    _t(self._poses[i]), float(a)).numpy()


class Fuser:
    """Visual-inertial fusion manager (Fuser.h:20-114 surface): gravity is
    the averaged accelerometer direction while converging; scale is the
    ratio of IMU-integrated to visual displacement over the ScaleInit
    windows."""

    def __init__(self, gravity_samples_needed: int = 60,
                 scale_windows_needed: int = 10):
        self.mode = FuserMode.WAIT_FOR_MAGE_INIT
        self._grav_accum = np.zeros(3)
        self._grav_count = 0
        self._grav_needed = gravity_samples_needed
        self._imu = UnfilteredIMU()
        self._scale_num = 0.0
        self._scale_den = 0.0
        self._scale_windows = 0
        self._scale_needed = scale_windows_needed
        self._last_visual_pose: Optional[np.ndarray] = None

    @property
    def has_gravity(self) -> bool:
        return self.mode.value >= FuserMode.SCALE_INIT.value

    @property
    def gravity_w(self) -> Optional[np.ndarray]:
        if not self.has_gravity:
            return None
        return self._imu.gravity_w

    @property
    def has_scale(self) -> bool:
        return self.mode == FuserMode.TRACKING

    @property
    def scale(self) -> Optional[float]:
        if not self.has_scale or self._scale_den <= 0:
            return None
        return self._scale_num / self._scale_den

    def on_mage_initialized(self):
        if self.mode == FuserMode.WAIT_FOR_MAGE_INIT:
            self.mode = FuserMode.GRAVITY_CONVERGE

    def on_visual_lost(self):
        if self.mode == FuserMode.TRACKING:
            self.mode = FuserMode.VISUAL_TRACKING_LOST

    def on_visual_reacquired(self):
        if self.mode == FuserMode.VISUAL_TRACKING_LOST:
            self.mode = FuserMode.TRACKING

    def process_fence(self, accel: np.ndarray, gyro: np.ndarray,
                      visual_pose: Optional[np.ndarray]):
        """Consume one image-fence window of samples and the visual pose."""
        if self.mode == FuserMode.GRAVITY_CONVERGE and len(accel):
            self._grav_accum += accel[:, 1:4].sum(axis=0)
            self._grav_count += len(accel)
            if self._grav_count >= self._grav_needed:
                g = self._grav_accum / max(np.linalg.norm(self._grav_accum),
                                           1e-9)
                self._imu.gravity_w = g * GRAVITY
                self.mode = FuserMode.SCALE_INIT
            return

        if self.mode in (FuserMode.SCALE_INIT, FuserMode.TRACKING):
            _, dp = self._imu.step(accel, gyro)
            if visual_pose is not None and \
                    self._last_visual_pose is not None:
                c0 = se3.camera_center(_t(self._last_visual_pose)).numpy()
                c1 = se3.camera_center(_t(visual_pose)).numpy()
                self._scale_num += float(np.linalg.norm(dp))
                self._scale_den += float(np.linalg.norm(c1 - c0))
                self._scale_windows += 1
                if self.mode == FuserMode.SCALE_INIT and \
                        self._scale_windows >= self._scale_needed:
                    self.mode = FuserMode.TRACKING
            if visual_pose is not None:
                self._last_visual_pose = visual_pose
