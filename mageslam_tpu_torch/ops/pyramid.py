"""Grayscale conversion and Gaussian smoothing (plain PyTorch).

Port of ``mageslam_tpu/ops/pyramid.py``.  The blur is written as explicit
shifted multiply-adds in float32 — horizontal pass over the reflect-101
padded rows, then the vertical pass, each tap added in order — so it is
the plain version of the CUDA kernel's blur (``ops/fast_cuda.py``) and
never goes through cuDNN's TF32 convolution.

The pyramid's levels are ``jax.image.resize(..., "linear")`` of the base
image: a triangle kernel widened by the scale when it downsamples
(antialiasing), its weights renormalised where it meets the border.  Here
the two separable weight matrices are built as ``jax.image.scale_and_
translate`` builds them and applied as two products (``F.interpolate``
with ``antialias=True`` places the same kernel but sums in another order,
up to 8e-4 grey levels away).  The matrices depend only on the shapes and
are cached per (input size, output size, device).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel1d(ksize: int, sigma: float | None = None,
                      device=None) -> torch.Tensor:
    if sigma is None or sigma <= 0:
        # OpenCV's default sigma for getGaussianKernel
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = torch.arange(ksize, dtype=torch.float32, device=device) \
        - (ksize - 1) / 2.0
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    # sum in index order: the float32 taps then equal jnp's bit for bit
    # (torch.sum reassociates)
    total = k[0]
    for i in range(1, ksize):
        total = total + k[i]
    return k / total


def _reflect_pad(img: torch.Tensor, pad_y: int, pad_x: int) -> torch.Tensor:
    """reflect-101 padding (``jnp.pad(mode="reflect")``)."""
    if pad_y == 0 and pad_x == 0:
        return img
    return F.pad(img[None, None], (pad_x, pad_x, pad_y, pad_y),
                 mode="reflect")[0, 0]


def blur_with_taps(img: torch.Tensor, taps: list) -> torch.Tensor:
    """Separable blur with explicit float32 taps: horizontal pass over the
    padded rows, then vertical, each tap multiplied and added in order."""
    h, w = img.shape
    pad = len(taps) // 2
    p = _reflect_pad(img, pad, pad)
    hb = None
    for i, tap in enumerate(taps):
        term = p[:, i:i + w] * tap
        hb = term if hb is None else hb + term
    vb = None
    for j, tap in enumerate(taps):
        term = hb[j:j + h, :] * tap
        vb = term if vb is None else vb + term
    return vb


def gaussian_blur(img: torch.Tensor, ksize: int = 7) -> torch.Tensor:
    """Separable Gaussian blur on (H, W) float32, reflect-101 borders."""
    if ksize <= 1:
        return img
    return blur_with_taps(img, gaussian_kernel1d(ksize).tolist())


def level_shape(h: int, w: int, level: int, scale_factor: float):
    s = scale_factor ** level
    return max(8, int(round(h / s))), max(8, int(round(w / s)))


_weights: dict = {}


def resize_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(in_size, out_size) float32 linear-resize weights: column ``o`` holds
    the normalised triangle taps of output sample ``o``
    (``jax.image.compute_weight_mat`` with ``antialias=True``), built on
    the host once per shape pair and device.

    The reference's levels come from XLA's CPU compile of that function,
    which evaluates the sample positions ``(o + 0.5) * inv_scale - 0.5``
    twice: as one fused multiply-add for the taps and unfused for the sum
    they are divided by, so a column sums to 1 only within 4e-6.  Both are
    reproduced here (the taps to 1.2e-7); exact weights put the levels up
    to 8e-4 grey levels from the reference's."""
    key = (in_size, out_size, str(torch.device(device or "cpu")))
    w = _weights.get(key)
    if w is None:
        # the scale is a Python float there: its inverse is rounded to
        # float32 once, from double
        inv = np.float32(1.0 / (out_size / in_size))
        kernel_scale = np.float32(max(1.0 / (out_size / in_size), 1.0))
        centre = np.arange(out_size, dtype=np.float32) + np.float32(0.5)
        src = np.arange(in_size, dtype=np.float32)[:, None]

        def taps(sample_f):
            x = np.abs(sample_f[None, :] - src) / kernel_scale
            return np.maximum(np.float32(0.0), np.float32(1.0) - x)

        fused = (centre.astype(np.float64) * np.float64(inv)
                 - 0.5).astype(np.float32)
        unfused = centre * inv - np.float32(0.5)
        wt = taps(fused)
        total = taps(unfused).sum(0, keepdims=True, dtype=np.float32)
        wt = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                      wt / np.where(total != 0, total, np.float32(1.0)),
                      np.float32(0.0))
        inside = (unfused >= -0.5) & (unfused <= in_size - 0.5)
        wt = np.where(inside[None, :], wt, np.float32(0.0))
        w = torch.as_tensor(wt.astype(np.float32)).to(device)
        _weights[key] = w
    return w


def resize_level(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(img, (h, w), "linear")``: rows, then columns."""
    wy = resize_weights(img.shape[0], h, img.device)
    wx = resize_weights(img.shape[1], w, img.device)
    return torch.matmul(torch.matmul(wy.T, img), wx)


def build_pyramid(img: torch.Tensor, num_levels: int,
                  scale_factor: float) -> list:
    """[level0, level1, ...]: level 0 is the input, level l the input
    resized to ``level_shape(h, w, l, scale_factor)``."""
    h, w = img.shape
    out = [img]
    for lvl in range(1, num_levels):
        out.append(resize_level(img, *level_shape(h, w, lvl, scale_factor)))
    return out


def to_gray_f32(img) -> torch.Tensor:
    """uint8 (H,W) or (H,W,3) BGR -> float32 grayscale in [0,255]."""
    x = torch.as_tensor(img)
    if x.ndim == 3:
        x = (0.299 * x[..., 2].to(torch.float32)
             + 0.587 * x[..., 1].to(torch.float32)
             + 0.114 * x[..., 0].to(torch.float32))
    return x.to(torch.float32)
