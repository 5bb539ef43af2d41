"""Whole-image undistortion: the frontend's image branch.

Port of ``mageslam_tpu/ops/undistort.py``.  With
``undistort_image_pixels`` the frontend rectifies the image through the
inverse distortion remap and detects on the rectified pixels against the
matching pinhole calibration, instead of undistorting only the keypoints.
The reference builds this from XLA ops, not from a kernel; here it is
plain torch on the image's device.

The remap grid depends only on the calibration: ``ImageRectifier`` builds it
once and keeps it, so a frame costs one bilinear gather.
"""

from __future__ import annotations

import torch

from mageslam_tpu_torch.geometry.camera import (CameraCalibration,
                                                distort_normalized)


def remap_grid(cal: CameraCalibration, device=None) -> torch.Tensor:
    """(H, W, 2) distorted source pixel of each rectified output pixel:
    normalise, apply the forward distortion, re-project (no inversion)."""
    h, w = int(cal.height), int(cal.width)
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device),
                          indexing="ij")
    xn = torch.stack([(u - cal.cx) / cal.fx, (v - cal.cy) / cal.fy], -1)
    xd = distort_normalized(cal, xn.reshape(-1, 2)).reshape(h, w, 2)
    return torch.stack([xd[..., 0] * cal.fx + cal.cx,
                        xd[..., 1] * cal.fy + cal.cy], -1)


def _bilinear(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    h, w = img.shape
    x = torch.clamp(grid[..., 0], 0.0, w - 1.000001)
    y = torch.clamp(grid[..., 1], 0.0, h - 1.000001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    wx = x - x0
    wy = y - y0
    return (img[y0, x0] * (1 - wx) * (1 - wy)
            + img[y0, x1] * wx * (1 - wy)
            + img[y1, x0] * (1 - wx) * wy
            + img[y1, x1] * wx * wy)


def undistort_image(img: torch.Tensor, cal: CameraCalibration,
                    grid: torch.Tensor | None = None) -> torch.Tensor:
    """Rectify a distorted (H, W) float32 image; samples outside the source
    clamp to its border (OpenCV's remap with border replication)."""
    if grid is None:
        grid = remap_grid(cal, img.device)
    return _bilinear(img, grid)


def undistorted_calibration(cal: CameraCalibration) -> CameraCalibration:
    """The pinhole calibration of the rectified image (distortion zeroed,
    intrinsics kept)."""
    return CameraCalibration.pinhole(cal.fx, cal.fy, cal.cx, cal.cy,
                                     int(cal.width), int(cal.height),
                                     device=cal.dist.device)


class ImageRectifier:
    """One calibration's remap grid, built on first use on the image's
    device and kept, with the pinhole calibration of its output."""

    def __init__(self, cal: CameraCalibration):
        self.cal = cal
        self.pinhole = undistorted_calibration(cal)
        self._grid = None

    def grid(self, device) -> torch.Tensor:
        if self._grid is None or self._grid.device != torch.device(device):
            self._grid = remap_grid(self.cal, device)
        return self._grid

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        return undistort_image(img, self.cal, self.grid(img.device))
