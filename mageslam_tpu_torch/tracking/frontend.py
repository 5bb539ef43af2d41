"""Feature-extraction frontend: image -> FrameFeatures.

Port of ``mageslam_tpu/tracking/frontend.py``: blur + FAST + NMS ->
gridded top-k -> subpixel refinement -> BRIEF -> keypoint undistortion.
The image stage goes through the kernel wrappers of ``ops/fast_cuda.py``,
which launch the CUDA kernel for a CUDA image (at any size) and take the
plain version for a CPU image.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mageslam_tpu_torch.config import PerCameraSettings
from mageslam_tpu_torch.geometry.camera import CameraCalibration, unproject
from mageslam_tpu_torch.ops import fast, fast_cuda, orb, pyramid, select


class FrameFeatures(NamedTuple):
    """Fixed-capacity per-frame features; ``valid`` masks detections."""

    uv: torch.Tensor          # (K, 2) float32 distorted pixels
    xn_undist: torch.Tensor   # (K, 2) float32 undistorted normalized
    response: torch.Tensor    # (K,) float32
    angle: torch.Tensor       # (K,) float32 radians
    octave: torch.Tensor      # (K,) int32 pyramid level
    desc: torch.Tensor        # (K, 8) int32 packed 256-bit BRIEF
    valid: torch.Tensor       # (K,) bool


def empty_features(max_features: int, device=None) -> FrameFeatures:
    k = max_features
    f32 = dict(dtype=torch.float32, device=device)
    return FrameFeatures(
        uv=torch.zeros((k, 2), **f32),
        xn_undist=torch.zeros((k, 2), **f32),
        response=torch.zeros((k,), **f32),
        angle=torch.zeros((k,), **f32),
        octave=torch.zeros((k,), dtype=torch.int32, device=device),
        desc=torch.zeros((k, 8), dtype=torch.int32, device=device),
        valid=torch.zeros((k,), dtype=torch.bool, device=device),
    )


def extract_features(img: torch.Tensor, cal: CameraCalibration,
                     fast_threshold: float,
                     max_features: int = 512,
                     num_levels: int = 1,
                     scale_factor: float = 1.5,
                     gaussian_ksize: int = 7,
                     use_orientation: bool = False,
                     cells_x: int = 32, cells_y: int = 32,
                     per_cell: int = 4,
                     use_subpixel: bool = True) -> FrameFeatures:
    """Full frontend on a grayscale float32 (H, W) image."""
    img = img.to(torch.float32)
    (lv_img,) = pyramid.build_pyramid(img, num_levels, scale_factor)
    if gaussian_ksize <= fast_cuda.MAX_KSIZE:
        # fused kernel: blur + FAST + NMS from one read of the frame
        score, smooth = fast_cuda.detect_and_smooth(
            lv_img, float(fast_threshold), gaussian_ksize)
    else:
        smooth = pyramid.gaussian_blur(lv_img, gaussian_ksize)
        score = fast_cuda.detect(lv_img, float(fast_threshold))
    kps = select.select_gridded(score, max_features, cells_x, cells_y,
                                per_cell)
    uv = kps.uv
    if use_subpixel:
        sp = fast.score_patches_at(lv_img, kps.uv, float(fast_threshold))
        uv = uv + fast.subpixel_offsets(sp) * kps.valid[:, None]
    angles, desc = orb.orient_and_describe(smooth, uv, use_orientation,
                                           bilinear=use_subpixel)
    xn = unproject(cal, uv)[..., :2]
    return FrameFeatures(
        uv=uv, xn_undist=xn, response=kps.response, angle=angles,
        octave=torch.zeros((max_features,), dtype=torch.int32,
                           device=img.device),
        desc=desc, valid=kps.valid)


def extract_for_settings(img: torch.Tensor, cal: CameraCalibration,
                         cam: PerCameraSettings,
                         max_features: int) -> FrameFeatures:
    """Frontend driven by a PerCameraSettings bag."""
    if cam.undistort_image_pixels:
        raise NotImplementedError(
            "undistort_image_pixels is not ported yet (queued with the "
            "multi-level pyramid)")
    fe = cam.features
    return extract_features(
        img, cal, fast_threshold=float(fe.fast_threshold),
        max_features=max_features, num_levels=int(fe.num_levels),
        scale_factor=float(fe.scale_factor),
        gaussian_ksize=int(fe.gaussian_kernel_size),
        use_orientation=bool(fe.use_orientation),
        cells_x=int(fe.num_cells_x), cells_y=int(fe.num_cells_y),
        use_subpixel=bool(getattr(fe, "use_subpixel", True)))
