"""Device characterization: camera calibrations, IMU spec, device defaults.

A copy of ``mageslam_tpu/device.py`` (numpy dataclasses) over the port's
``CameraCalibration``.

Equivalent of the reference's Device/ subsystem:
- CameraCalibration lives in geometry/camera.py (Device/CameraCalibration.h:
  17-89: K matrix + distortion variants) — re-exported here.
- IMUCharacterization (Device/IMUCharacterization.h): sensor noise /
  bias / alignment / rate description handed to MAGESlam's constructor
  (MageSlam.h:130) and the fuser.
- Per-device defaults (Device/SupportedDevices.cpp: GetSettingsForDevice-
  style tables) — named profiles bundling calibration + IMU + settings
  overrides.
- CameraSettings (Platform/CameraSettings.h): per-frame exposure / ISO /
  white balance attached to frames (MageSlam.h Frame carries them).

The reference's LinearFocalLengthModel (Data/Data.h:150-330: focal length
as a linear function of lens position, for AF cameras) is provided as
``LinearFocalLengthModel.calibration_at(lens_position)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from mageslam_tpu_torch.geometry.camera import CameraCalibration


@dataclass(frozen=True)
class CameraSettings:
    """Per-frame capture settings (Platform/CameraSettings.h analog)."""

    exposure_time_s: float = 0.0
    iso: int = 0
    white_balance: int = 0
    lens_position: float = 0.0


@dataclass(frozen=True)
class IMUCharacterization:
    """IMU spec (Device/IMUCharacterization.h analog).

    Noise densities follow the usual continuous-time convention
    (accel: m/s^2/sqrt(Hz), gyro: rad/s/sqrt(Hz)); body_to_camera is a
    4x4 row-major extrinsic.
    """

    use_fuser: bool = False
    sample_rate_hz: float = 200.0
    accel_noise_density: float = 2.0e-3
    gyro_noise_density: float = 1.7e-4
    accel_bias_instability: float = 3.0e-3
    gyro_bias_instability: float = 2.0e-5
    body_to_camera: Tuple[float, ...] = field(
        default_factory=lambda: tuple(np.eye(4, dtype=np.float32).ravel()))

    def body_to_camera_mat(self) -> np.ndarray:
        return np.asarray(self.body_to_camera,
                          np.float32).reshape(4, 4)

    def accel_covariance(self) -> float:
        """Per-sample accel variance at the configured rate."""
        return (self.accel_noise_density ** 2) * self.sample_rate_hz

    def gyro_covariance(self) -> float:
        return (self.gyro_noise_density ** 2) * self.sample_rate_hz


@dataclass(frozen=True)
class LinearFocalLengthModel:
    """Focal length as a linear function of lens position
    (Data/Data.h LinearFocalLengthModel: f = m * lensPos + b, per axis,
    with principal point fixed)."""

    m_fx: float
    b_fx: float
    m_fy: float
    b_fy: float
    cx: float
    cy: float
    width: int = 320
    height: int = 180

    def calibration_at(self, lens_position: float) -> CameraCalibration:
        return CameraCalibration.pinhole(
            self.m_fx * lens_position + self.b_fx,
            self.m_fy * lens_position + self.b_fy,
            self.cx, self.cy, self.width, self.height)


@dataclass(frozen=True)
class DeviceProfile:
    """A supported device: calibration + IMU + settings overrides
    (Device/SupportedDevices.cpp analog)."""

    name: str
    calibration: CameraCalibration
    imu: IMUCharacterization
    settings_overrides: Dict[str, object] = field(default_factory=dict)


def _euroc_mono() -> DeviceProfile:
    # EuRoC MAV cam0 intrinsics (Aptina MT9V034, 752x480, radtan), scaled
    # to the reference's 320-wide tracking resolution (console.cpp:70)
    s = 320.0 / 752.0
    cal = CameraCalibration.poly3k(
        458.654 * s, 457.296 * s, 367.215 * s, 248.375 * s,
        -0.28340811, 0.07395907, 0.0, width=320, height=204)
    imu = IMUCharacterization(
        use_fuser=False, sample_rate_hz=200.0,
        accel_noise_density=2.0000e-3, gyro_noise_density=1.6968e-4,
        accel_bias_instability=3.0000e-3, gyro_bias_instability=1.9393e-5)
    return DeviceProfile("euroc_mono", cal, imu)


def _synthetic_default() -> DeviceProfile:
    cal = CameraCalibration.pinhole(272.0, 272.0, 160.0, 90.0, 320, 180)
    return DeviceProfile("synthetic_default", cal, IMUCharacterization())


def _tum_mono() -> DeviceProfile:
    # TUM RGB-D fr1 intrinsics scaled to 320 wide
    s = 320.0 / 640.0
    cal = CameraCalibration.poly3k(
        517.3 * s, 516.5 * s, 318.6 * s, 255.3 * s,
        0.2624, -0.9531, 1.1633, width=320, height=240)
    return DeviceProfile("tum_mono", cal, IMUCharacterization(
        sample_rate_hz=500.0))


_PROFILES = {
    p.name: p for p in (_synthetic_default(), _euroc_mono(), _tum_mono())
}


def supported_devices() -> Tuple[str, ...]:
    return tuple(_PROFILES)


def get_device_profile(name: str) -> DeviceProfile:
    try:
        return _PROFILES[name]
    except KeyError:
        raise KeyError(
            f"unknown device {name!r}; supported: {supported_devices()}")
