"""Camera models: pinhole + polynomial / rational distortion.

Port of ``mageslam_tpu/geometry/camera.py``.  The calibration holds plain
Python floats for the intrinsics and a (8,) distortion tensor in OpenCV
layout ``[k1 k2 p1 p2 k3 k4 k5 k6]``; the model id is a Python int, so the
pinhole case skips the distortion arithmetic exactly where the JAX package
selected the undistorted value with ``jnp.where``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mageslam_tpu_torch.geometry import se3

MODEL_PINHOLE = 0
MODEL_POLY3K = 1
MODEL_RATIONAL6K = 2


def _f32(x) -> float:
    """A Python float holding a float32 value, as the JAX calibration's
    float32 scalars do."""
    return float(np.float32(x))


class CameraCalibration(NamedTuple):
    """Intrinsics in pixels (float32 values held as Python floats),
    (8,) distortion, model id and the calibrated image size."""

    fx: float
    fy: float
    cx: float
    cy: float
    dist: torch.Tensor        # (8,) float32
    model: int
    width: int = 320
    height: int = 180

    @staticmethod
    def pinhole(fx, fy, cx, cy, width=320, height=180, device=None):
        return CameraCalibration(
            _f32(fx), _f32(fy), _f32(cx), _f32(cy),
            torch.zeros(8, dtype=torch.float32, device=device),
            MODEL_PINHOLE, int(width), int(height))

    @staticmethod
    def poly3k(fx, fy, cx, cy, k1, k2, k3, width=320, height=180,
               device=None):
        d = torch.tensor([k1, k2, 0.0, 0.0, k3, 0.0, 0.0, 0.0],
                         dtype=torch.float32, device=device)
        return CameraCalibration(_f32(fx), _f32(fy), _f32(cx), _f32(cy),
                                 d, MODEL_POLY3K, int(width), int(height))

    @staticmethod
    def rational6k(fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, k5, k6,
                   width=320, height=180, device=None):
        d = torch.tensor([k1, k2, p1, p2, k3, k4, k5, k6],
                         dtype=torch.float32, device=device)
        return CameraCalibration(_f32(fx), _f32(fy), _f32(cx), _f32(cy),
                                 d, MODEL_RATIONAL6K, int(width),
                                 int(height))

    def to(self, device) -> "CameraCalibration":
        return self._replace(dist=self.dist.to(device))

    def k_matrix(self) -> torch.Tensor:
        """(3, 3) float32 intrinsic matrix, on the distortion's device."""
        return torch.tensor([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
                             [0.0, 0.0, 1.0]], dtype=torch.float32,
                            device=self.dist.device)

    def scaled(self, sx: float, sy: float) -> "CameraCalibration":
        """The calibration of the image resized by (sx, sy).  Each product
        is rounded to float32, as the JAX calibration's float32 scalars
        multiply."""
        sx32, sy32 = _f32(sx), _f32(sy)
        return self._replace(
            fx=_f32(self.fx * sx32), fy=_f32(self.fy * sy32),
            cx=_f32(self.cx * sx32), cy=_f32(self.cy * sy32),
            width=int(round(self.width * sx)),
            height=int(round(self.height * sy)))


def distort_normalized(cal: CameraCalibration,
                       xn: torch.Tensor) -> torch.Tensor:
    if cal.model == MODEL_PINHOLE:
        return xn
    k1, k2, p1, p2, k3, k4, k5, k6 = cal.dist.to(xn.device).unbind(-1)
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    num = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
    den = 1.0 + k4 * r2 + k5 * r4 + k6 * r6
    radial = num / den
    dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([x * radial + dx, y * radial + dy], -1)


def undistort_normalized(cal: CameraCalibration, xd: torch.Tensor,
                         iters: int = 8) -> torch.Tensor:
    """Fixed-point inversion of the distortion (fixed iteration count)."""
    if cal.model == MODEL_PINHOLE:
        return xd
    xn = xd
    for _ in range(iters):
        delta = distort_normalized(cal, xn) - xn
        xn = xd - delta
    return xn


def project(cal: CameraCalibration, x_cam: torch.Tensor):
    """Camera-frame points (..., 3) -> pixels (..., 2), depth (...,)."""
    z = x_cam[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.sign(z) * 1e-9 + 1e-12, z)
    xn = x_cam[..., :2] / zs[..., None]
    xd = distort_normalized(cal, xn)
    # a Python float meets a float32 tensor as a float32 scalar, which is
    # what the JAX calibration holds
    fx, fy, cx, cy = cal.fx, cal.fy, cal.cx, cal.cy
    u = fx * xd[..., 0] + cx
    v = fy * xd[..., 1] + cy
    return torch.stack([u, v], -1), z


def unproject(cal: CameraCalibration, uv: torch.Tensor,
              depth: torch.Tensor | None = None) -> torch.Tensor:
    fx, fy, cx, cy = cal.fx, cal.fy, cal.cx, cal.cy
    xn = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)
    xn = undistort_normalized(cal, xn)
    ray = torch.cat([xn, torch.ones_like(xn[..., :1])], -1)
    if depth is not None:
        ray = ray * depth[..., None]
    return ray


def in_bounds(cal: CameraCalibration, uv: torch.Tensor,
              border: float = 0.0) -> torch.Tensor:
    return ((uv[..., 0] >= border) & (uv[..., 0] <= cal.width - 1 - border)
            & (uv[..., 1] >= border)
            & (uv[..., 1] <= cal.height - 1 - border))


def project_world(cal: CameraCalibration, pose7: torch.Tensor,
                  x_world: torch.Tensor):
    """World points through a view pose to pixels: (uv, depth)."""
    return project(cal, se3.pose_apply(pose7, x_world))


class LinearFocalLengthModel(NamedTuple):
    """Focal length as a linear function of lens position, f = m * lens +
    b in units of the image width, principal point normalized to [0, 1]."""

    m: float
    b: float
    cx: float
    cy: float

    def calibration(self, lens_position, width, height, dist=None,
                    model=MODEL_PINHOLE) -> CameraCalibration:
        f = _f32(_f32(_f32(self.m) * _f32(lens_position)) + _f32(self.b))
        d = torch.zeros(8, dtype=torch.float32) if dist is None else \
            torch.as_tensor(dist, dtype=torch.float32)
        return CameraCalibration(
            _f32(f * _f32(width)), _f32(f * _f32(width)),
            _f32(_f32(self.cx) * _f32(width)),
            _f32(_f32(self.cy) * _f32(height)), d, int(model), int(width),
            int(height))
