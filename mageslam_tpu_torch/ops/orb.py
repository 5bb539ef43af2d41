"""Oriented BRIEF descriptors, batched over keypoints.

Port of ``mageslam_tpu/ops/orb.py``.  The sampling pattern comes from the
same numpy generator and seed, copied verbatim (the JAX module imports
jax), so descriptors are identical bit for bit given identical patches.
Descriptors are (K, 8) 32-bit words stored as ``torch.int32`` with the JAX
package's bit layout (bit j of word w is pair 32*w + j).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

PATCH_RADIUS = 15
PATCH = 2 * PATCH_RADIUS + 1
PATTERN_RADIUS = 13
NUM_PAIRS = 256
DESC_WORDS = 8


def _make_pattern(seed: int = 20240612) -> np.ndarray:
    """(NUM_PAIRS, 4) int32 [x1 y1 x2 y2], Gaussian pairs in a r=13 disc."""
    rng = np.random.default_rng(seed)
    pts = []
    while len(pts) < NUM_PAIRS * 2:
        cand = rng.normal(0.0, PATTERN_RADIUS / 2.0, size=(NUM_PAIRS, 2))
        cand = np.round(cand).astype(np.int32)
        ok = (cand[:, 0] ** 2 + cand[:, 1] ** 2) <= PATTERN_RADIUS ** 2
        pts.extend(cand[ok].tolist())
    pts = np.asarray(pts[:NUM_PAIRS * 2], dtype=np.int32)
    return np.concatenate([pts[:NUM_PAIRS], pts[NUM_PAIRS:]], axis=1)


_PAT_NP = _make_pattern()


def _disc_mask(radius: int) -> np.ndarray:
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return (x * x + y * y <= radius * radius).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _constants(device: str):
    """Per-device constant tensors: pattern, flat sample indices of the
    unrotated pattern, and the disc-weighted moment vectors."""
    dev = torch.device(device)
    pat = torch.as_tensor(_PAT_NP, device=dev)
    i1 = torch.as_tensor((_PAT_NP[:, 1] + PATCH_RADIUS) * PATCH
                         + (_PAT_NP[:, 0] + PATCH_RADIUS), device=dev)
    i2 = torch.as_tensor((_PAT_NP[:, 3] + PATCH_RADIUS) * PATCH
                         + (_PAT_NP[:, 2] + PATCH_RADIUS), device=dev)
    grid = np.mgrid[-PATCH_RADIUS:PATCH_RADIUS + 1,
                    -PATCH_RADIUS:PATCH_RADIUS + 1].astype(np.float32)
    disc = _disc_mask(PATCH_RADIUS)
    wx = torch.as_tensor((disc * grid[1]).reshape(-1), device=dev)
    wy = torch.as_tensor((disc * grid[0]).reshape(-1), device=dev)
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    return pat, i1.long(), i2.long(), wx, wy, shifts


def _slice_patches(p: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   size: int) -> torch.Tensor:
    """(K, size, size) windows of p at top-left (y, x), start indices
    clamped into range like ``lax.dynamic_slice``."""
    ph, pw = p.shape
    x = torch.clamp(x, 0, pw - size)
    y = torch.clamp(y, 0, ph - size)
    ar = torch.arange(size, device=p.device)
    rows = (y[:, None] + ar[None, :])[:, :, None]
    cols = (x[:, None] + ar[None, :])[:, None, :]
    return p[rows, cols]


def _extract_patches(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """(K, 31, 31) patches centred on integer keypoint coords (zero pad)."""
    pad = PATCH_RADIUS + 1
    p = torch.nn.functional.pad(img, (pad, pad, pad, pad))
    x = uv[:, 0].to(torch.int32).long() + pad - PATCH_RADIUS
    y = uv[:, 1].to(torch.int32).long() + pad - PATCH_RADIUS
    return _slice_patches(p, x, y, PATCH)


def _extract_patches_bilinear(img: torch.Tensor,
                              uv: torch.Tensor) -> torch.Tensor:
    """(K, 31, 31) patches bilinearly resampled at fractional centres."""
    pad = PATCH_RADIUS + 2
    p = torch.nn.functional.pad(img, (pad, pad, pad, pad))
    base = torch.floor(uv)
    frac = uv - base
    x = base[:, 0].to(torch.int32).long() + pad - PATCH_RADIUS
    y = base[:, 1].to(torch.int32).long() + pad - PATCH_RADIUS
    q = _slice_patches(p, x, y, PATCH + 1)
    fx = frac[:, 0, None, None]
    fy = frac[:, 1, None, None]
    return (q[:, :-1, :-1] * (1 - fy) * (1 - fx)
            + q[:, :-1, 1:] * (1 - fy) * fx
            + q[:, 1:, :-1] * fy * (1 - fx)
            + q[:, 1:, 1:] * fy * fx)


def patch_orientations(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angles (K,) from (K, 31, 31) patches."""
    _, _, _, wx, wy, _ = _constants(str(patches.device))
    flat = patches.reshape(patches.shape[0], PATCH * PATCH)
    return torch.atan2(flat @ wy, flat @ wx)


def compute_orientations(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angles (K,) in radians at keypoints uv."""
    return patch_orientations(_extract_patches(img, uv))


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) bool -> (..., 8) int32 words (uint32 bit pattern)."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    b = bits.to(torch.int64).reshape(bits.shape[:-1] + (DESC_WORDS, 32))
    v = torch.sum(b << shifts, dim=-1)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def _descriptors_from_patches(patches: torch.Tensor, angles: torch.Tensor,
                              use_orientation: bool) -> torch.Tensor:
    pat, i1, i2, _, _, _ = _constants(str(patches.device))
    flat = patches.reshape(patches.shape[0], PATCH * PATCH)
    if use_orientation:
        patf = pat.to(torch.float32)
        c = torch.cos(angles)[:, None]
        s = torch.sin(angles)[:, None]
        x1 = patf[None, :, 0] * c - patf[None, :, 1] * s
        y1 = patf[None, :, 0] * s + patf[None, :, 1] * c
        x2 = patf[None, :, 2] * c - patf[None, :, 3] * s
        y2 = patf[None, :, 2] * s + patf[None, :, 3] * c

        def sample(xs, ys):
            xi = torch.clamp(torch.round(xs).long() + PATCH_RADIUS, 0,
                             PATCH - 1)
            yi = torch.clamp(torch.round(ys).long() + PATCH_RADIUS, 0,
                             PATCH - 1)
            return torch.gather(flat, 1, yi * PATCH + xi)

        v1, v2 = sample(x1, y1), sample(x2, y2)
    else:
        # unrotated pattern: constant-index gather (the JAX package's
        # exact one-hot matmul picks the same values)
        v1, v2 = flat[:, i1], flat[:, i2]
    return _pack_bits(v1 < v2)


def compute_descriptors(img_smooth: torch.Tensor, uv: torch.Tensor,
                        angles: torch.Tensor,
                        use_orientation: bool = True) -> torch.Tensor:
    """(K, 8) int32 rotated-BRIEF words (uint32 bit pattern) of a blurred
    image; plain BRIEF with ``use_orientation=False``."""
    return _descriptors_from_patches(_extract_patches(img_smooth, uv),
                                     angles, use_orientation)


def orient_and_describe(img_smooth: torch.Tensor, uv: torch.Tensor,
                        use_orientation: bool = True,
                        bilinear: bool = False):
    """(angles (K,), desc (K, 8) int32) from one patch extraction."""
    patches = (_extract_patches_bilinear(img_smooth, uv) if bilinear
               else _extract_patches(img_smooth, uv))
    angles = patch_orientations(patches)
    return angles, _descriptors_from_patches(patches, angles,
                                             use_orientation)
