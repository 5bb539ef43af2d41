"""Feature-extraction frontend: image -> FrameFeatures.

Port of ``mageslam_tpu/tracking/frontend.py``: blur + FAST + NMS ->
gridded top-k -> subpixel refinement -> BRIEF -> keypoint undistortion.
Each pyramid level goes through the kernel wrappers of
``ops/fast_cuda.py``, which launch the CUDA kernel for a CUDA image (at any
size: level widths that are not a multiple of four take the kernel's
unaligned load route) and take the plain version for a CPU image.
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
    """Full frontend on a grayscale float32 (H, W) image.

    With ``num_levels > 1`` the feature budget is split over the pyramid's
    levels by pixel area (at least 16 each; level 0 absorbs the rounding),
    each level is detected, selected, refined and described on its own
    image, and its keypoints are mapped back to level-0 pixels."""
    img = img.to(torch.float32)
    levels = pyramid.build_pyramid(img, num_levels, scale_factor)
    areas = [lv.shape[0] * lv.shape[1] for lv in levels]
    budgets = [max(16, int(round(max_features * a / sum(areas))))
               for a in areas]
    budgets[0] += max_features - sum(budgets)
    parts = []
    for lvl, (lv_img, budget) in enumerate(zip(levels, budgets)):
        if gaussian_ksize <= fast_cuda.MAX_KSIZE:
            # fused kernel: blur + FAST + NMS from one read of the level
            score, smooth = fast_cuda.detect_and_smooth(
                lv_img, float(fast_threshold), gaussian_ksize)
        else:
            smooth = pyramid.gaussian_blur(lv_img, gaussian_ksize)
            score = fast_cuda.detect(lv_img, float(fast_threshold))
        kps = select.select_gridded(score, budget, cells_x, cells_y,
                                    per_cell)
        uv = kps.uv
        if use_subpixel:
            sp = fast.score_patches_at(lv_img, kps.uv, float(fast_threshold))
            uv = uv + fast.subpixel_offsets(sp) * kps.valid[:, None]
        angles, desc = orb.orient_and_describe(smooth, uv, use_orientation,
                                               bilinear=use_subpixel)
        parts.append((uv * scale_factor ** lvl, kps.response, angles,
                      torch.full((budget,), lvl, dtype=torch.int32,
                                 device=img.device), desc, kps.valid))
    uv, response, angles, octave, desc, valid = (
        torch.cat(xs) if len(parts) > 1 else xs[0] for xs in zip(*parts))
    xn = unproject(cal, uv)[..., :2]
    return FrameFeatures(uv=uv, xn_undist=xn, response=response,
                         angle=angles, octave=octave, desc=desc, valid=valid)


def extract_for_settings(img: torch.Tensor, cal: CameraCalibration,
                         cam: PerCameraSettings, max_features: int,
                         rectifier=None) -> FrameFeatures:
    """Frontend driven by a PerCameraSettings bag.

    With ``undistort_image_pixels`` the image is rectified first
    (``ops/undistort.py``) and detection runs on the rectified pixels
    against the matching pinhole calibration; otherwise only the
    keypoints are undistorted.  The fused engine's step does not come
    here: it calls ``extract_features`` and so undistorts keypoints
    whatever the flag says, as the JAX engine's step does; stereo
    initialization comes here.  ``rectifier`` (an
    ``undistort.ImageRectifier`` of ``cal``) keeps the remap grid between
    calls; without one the grid is built for this call."""
    if cam.undistort_image_pixels:
        from mageslam_tpu_torch.ops import undistort
        rectifier = rectifier or undistort.ImageRectifier(cal)
        img = rectifier(img.to(torch.float32))
        cal = rectifier.pinhole
    fe = cam.features
    return extract_features(
        img, cal, fast_threshold=float(fe.fast_threshold),
        max_features=max_features, num_levels=int(fe.num_levels),
        scale_factor=float(fe.scale_factor),
        gaussian_ksize=int(fe.gaussian_kernel_size),
        use_orientation=bool(fe.use_orientation),
        cells_x=int(fe.num_cells_x), cells_y=int(fe.num_cells_y),
        use_subpixel=bool(getattr(fe, "use_subpixel", True)))
