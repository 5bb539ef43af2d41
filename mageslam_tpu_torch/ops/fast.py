"""FAST-9/16 corner detection, plain PyTorch versions.

Port of ``mageslam_tpu/ops/fast.py``.  These are the plain versions of
the CUDA kernel in ``ops/fast_cuda.py``: the frontend uses them for CPU
tensors, and the tests and ``chip_smoke.py`` hold the kernel against them.
The score keeps the JAX order of operations — ``(c - center) - thr`` and
``(center - c) - thr`` — and otherwise uses only min and max, so it is
bit-exact across implementations.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from mageslam_tpu_torch.ops import pyramid

# Bresenham circle of radius 3 (dx, dy), from 12 o'clock clockwise
CIRCLE_OFFSETS = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
ARC_LENGTH = 9
PAD = 3   # circle radius; also the 7-tap blur apron


def _arc_score(d: torch.Tensor, dim: int) -> torch.Tensor:
    """max over the 16 cyclic length-9 arcs of the arc's minimum."""
    dd = torch.cat([d, d.narrow(dim, 0, ARC_LENGTH - 1)], dim)
    wins = [dd.narrow(dim, k, ARC_LENGTH).amin(dim) for k in range(16)]
    return torch.stack(wins, dim).amax(dim)


def fast_score_map(img: torch.Tensor, threshold) -> torch.Tensor:
    """Raw FAST-9/16 margin score (H, W); 0 on the 3-pixel border."""
    img = img.to(torch.float32)
    h, w = img.shape
    t = float(threshold)
    p = F.pad(img, (PAD, PAD, PAD, PAD))
    circle = torch.stack([p[PAD + dy:PAD + dy + h, PAD + dx:PAD + dx + w]
                          for dx, dy in CIRCLE_OFFSETS])
    d_bright = circle - img[None] - t
    d_dark = img[None] - circle - t
    score = torch.maximum(_arc_score(d_bright, 0), _arc_score(d_dark, 0))
    score = torch.clamp(score, min=0.0)
    interior = torch.zeros_like(score, dtype=torch.bool)
    interior[PAD:h - PAD, PAD:w - PAD] = True
    return torch.where(interior, score, torch.zeros_like(score))


def antipodal_candidates(img: torch.Tensor, threshold):
    """(bright, dark) boolean maps (H, W): the exact early-out test that the
    CUDA kernel runs before the arc scan.

    Any cyclic arc of 9 of the 16 ring pixels holds an antipodal pair
    (k, k+8), and float32 rounding is monotone, so min and max commute with
    the score's subtractions.  With P the largest pair minimum and Q the
    smallest pair maximum of the raw ring values, a positive bright score
    needs ``(P - center) - thr > 0``, which (round to nearest, no flush to
    zero) holds exactly when ``P - center > thr``; a positive dark score
    needs ``Q - center < -thr``.  A pixel that fails both tests has a raw
    score of exactly 0.  The condition is necessary, not sufficient:
    candidates still go through the arc scan.  False on the 3-pixel
    border."""
    img = img.to(torch.float32)
    h, w = img.shape
    t = float(threshold)
    p = F.pad(img, (PAD, PAD, PAD, PAD))
    c = torch.stack([p[PAD + dy:PAD + dy + h, PAD + dx:PAD + dx + w]
                     for dx, dy in CIRCLE_OFFSETS])
    bright = torch.minimum(c[:8], c[8:]).amax(0) - img > t
    dark = torch.maximum(c[:8], c[8:]).amin(0) - img < -t
    interior = torch.zeros_like(bright)
    interior[PAD:h - PAD, PAD:w - PAD] = True
    return bright & interior, dark & interior


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep scores that are the max of their 3x3 neighbourhood (ties kept);
    outside the image counts as 0."""
    m = F.max_pool2d(F.pad(score[None, None], (1, 1, 1, 1)), 3, 1)[0, 0]
    return torch.where((score >= m) & (score > 0), score,
                       torch.zeros_like(score))


def detect(img: torch.Tensor, threshold) -> torch.Tensor:
    """NMS'd score map: the plain version of the ``fast_detect`` kernel."""
    return nms3x3(fast_score_map(img, threshold))


def detect_and_smooth(img: torch.Tensor, threshold, ksize: int = 7):
    """(NMS'd score, Gaussian-smoothed image): the plain version of the
    ``fast_detect_and_smooth`` kernel."""
    img = img.to(torch.float32)
    return detect(img, threshold), pyramid.gaussian_blur(img, ksize)


@functools.lru_cache(maxsize=8)
def _circle_index(device: str):
    dev = torch.device(device)
    cdx = torch.tensor([dx for dx, dy in CIRCLE_OFFSETS], device=dev)
    cdy = torch.tensor([dy for dx, dy in CIRCLE_OFFSETS], device=dev)
    return cdx, cdy


def score_patches_at(img: torch.Tensor, uv: torch.Tensor,
                     threshold) -> torch.Tensor:
    """(K, 3, 3) raw FAST score neighbourhoods at integer keypoints (the
    gather recompute that feeds subpixel refinement)."""
    img = img.to(torch.float32)
    h, w = img.shape
    t = float(threshold)
    x0 = torch.clamp(torch.round(uv[:, 0]).to(torch.int64), 4, w - 5)
    y0 = torch.clamp(torch.round(uv[:, 1]).to(torch.int64), 4, h - 5)
    offs = torch.arange(-1, 2, device=img.device)
    ys = (y0[:, None, None] + offs[None, :, None]).expand(-1, 3, 3)
    xs = (x0[:, None, None] + offs[None, None, :]).expand(-1, 3, 3)
    centers = img[ys, xs]
    cdx, cdy = _circle_index(str(img.device))
    cy = torch.clamp(ys[..., None] + cdy, 0, h - 1)
    cx = torch.clamp(xs[..., None] + cdx, 0, w - 1)
    circ = img[cy, cx]
    d_bright = circ - centers[..., None] - t
    d_dark = centers[..., None] - circ - t
    sc = torch.maximum(_arc_score(d_bright, -1), _arc_score(d_dark, -1))
    return torch.clamp(sc, min=0.0)


def subpixel_offsets(patches: torch.Tensor) -> torch.Tensor:
    """(K, 2) parabola-vertex offsets in [-0.5, 0.5]; zero where the
    centre is not a proper maximum."""
    s0 = patches[:, 1, 1]
    sxm, sxp = patches[:, 1, 0], patches[:, 1, 2]
    sym, syp = patches[:, 0, 1], patches[:, 2, 1]
    denx = sxm + sxp - 2.0 * s0
    deny = sym + syp - 2.0 * s0
    zero = torch.zeros_like(s0)
    ox = torch.where(denx < -1e-6, (sxm - sxp) / (2.0 * denx), zero)
    oy = torch.where(deny < -1e-6, (sym - syp) / (2.0 * deny), zero)
    return torch.stack([torch.clamp(ox, -0.5, 0.5),
                        torch.clamp(oy, -0.5, 0.5)], -1)
