"""Least device time of the FAST kernel (``fast_detect_and_smooth``: 7-tap
blur, FAST-9/16 score, 3x3 NMS, from one read of the grey level) on one
frame, against the published peaks of one H100 SXM.

- Bytes: the float32 grey frame read once, the NMS'd score and the
  smoothed frame written once: ``3 * 4 * H * W``.  At 3.35e12 B/s.
- Operations: per interior pixel the antipodal early-out test (16
  differences, 16 pair minima or maxima, 14 to reduce them, 2 compares:
  48); per candidate polarity the arc scan (64 minima, 16 maxima, the
  threshold and the clamp: 82); per pixel the NMS (8 maxima, 2 compares:
  10) and the two 7-tap blur passes (7 multiplies and 6 adds each: 26).
  None of them is a fused multiply-add, so each is one instruction, and
  the card issues at most half of the data sheet's 67e12 float32
  operations a second (which counts a multiply-add as two): 33.5e12/s.
  Candidates are counted from the frame itself, since the scan runs only
  where the early-out test passes.

The least time is the larger of the two.  The same arithmetic as
``chip_smoke.py``'s ``roofline_bound``, frozen here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12 / 2
PAIR_TEST_OPS, ARC_SCAN_OPS, NMS_OPS, BLUR_OPS = 48, 82, 10, 26
CIRCLE = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2),
          (1, 3), (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1),
          (-2, -2), (-1, -3))


def candidates(img: torch.Tensor, threshold: float) -> int:
    """Pixels x polarities that pass the early-out test (the largest
    antipodal-pair minimum above the centre by more than the threshold,
    or the smallest pair maximum below it)."""
    img = img.to(torch.float32)
    h, w = img.shape
    p = F.pad(img, (3, 3, 3, 3))
    c = torch.stack([p[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                     for dx, dy in CIRCLE])
    bright = torch.minimum(c[:8], c[8:]).amax(0) - img > threshold
    dark = torch.maximum(c[:8], c[8:]).amin(0) - img < -threshold
    inner = torch.zeros_like(bright)
    inner[3:h - 3, 3:w - 3] = True
    return int((bright & inner).sum()) + int((dark & inner).sum())


def work(h: int, w: int, scans: int) -> tuple:
    """(operations, bytes) of one launch on an (h, w) frame."""
    interior = max(h - 6, 0) * max(w - 6, 0)
    ops = interior * PAIR_TEST_OPS + scans * ARC_SCAN_OPS \
        + h * w * (NMS_OPS + BLUR_OPS)
    return ops, 3 * 4 * h * w


def least_seconds(h: int, w: int, scans: int) -> float:
    ops, nbytes = work(h, w, scans)
    return max(nbytes / BYTES_PER_S, ops / OPS_PER_S)
