"""Plain reference of the frontend: grey frame -> keypoints + descriptors.

A frozen copy of the port's plain frontend at one pyramid level (7-tap
Gaussian blur, FAST-9/16 with 3x3 non-maximum suppression, gridded top-k,
parabola subpixel refinement, intensity-centroid angle, BRIEF over a
bilinear patch, pinhole unprojection), written out in plain PyTorch.  It
imports nothing of the program, so a later change to the program cannot
move it.  Every operation is elementwise, a min/max, a stable sort or a
gather, except the two moment products of the angle; those run in
float32 as the program runs them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

CIRCLE = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2),
          (1, 3), (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1),
          (-2, -2), (-1, -3))
ARC = 9
PAD = 3
PATCH_RADIUS = 15
PATCH = 2 * PATCH_RADIUS + 1
PATTERN_RADIUS = 13
NUM_PAIRS = 256


def _stable_topk(x, k):
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _argsort(x, dim=-1):
    return torch.sort(x, dim=dim, stable=True).indices


def gaussian_taps(ksize: int) -> list:
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = torch.arange(ksize, dtype=torch.float32) - (ksize - 1) / 2.0
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    total = k[0]
    for i in range(1, ksize):        # index order, as the program sums
        total = total + k[i]
    return (k / total).tolist()


def blur(img, ksize: int = 7):
    """Separable blur, reflect-101 borders, each tap added in order."""
    h, w = img.shape
    taps = gaussian_taps(ksize)
    pad = len(taps) // 2
    p = F.pad(img[None, None], (pad, pad, pad, pad), mode="reflect")[0, 0]
    hb = None
    for i, tap in enumerate(taps):
        term = p[:, i:i + w] * tap
        hb = term if hb is None else hb + term
    vb = None
    for j, tap in enumerate(taps):
        term = hb[j:j + h, :] * tap
        vb = term if vb is None else vb + term
    return vb


def _arc_score(d, dim):
    dd = torch.cat([d, d.narrow(dim, 0, ARC - 1)], dim)
    wins = [dd.narrow(dim, k, ARC).amin(dim) for k in range(16)]
    return torch.stack(wins, dim).amax(dim)


def fast_score(img, threshold: float):
    """Raw FAST-9/16 margin, 0 on the 3-pixel border."""
    h, w = img.shape
    p = F.pad(img, (PAD, PAD, PAD, PAD))
    circle = torch.stack([p[PAD + dy:PAD + dy + h, PAD + dx:PAD + dx + w]
                          for dx, dy in CIRCLE])
    score = torch.maximum(_arc_score(circle - img[None] - threshold, 0),
                          _arc_score(img[None] - circle - threshold, 0))
    score = torch.clamp(score, min=0.0)
    inner = torch.zeros_like(score, dtype=torch.bool)
    inner[PAD:h - PAD, PAD:w - PAD] = True
    return torch.where(inner, score, torch.zeros_like(score))


def nms3x3(score):
    m = F.max_pool2d(F.pad(score[None, None], (1, 1, 1, 1)), 3, 1)[0, 0]
    return torch.where((score >= m) & (score > 0), score,
                       torch.zeros_like(score))


def select_gridded(score, k: int, cells_x: int, cells_y: int,
                   per_cell: int = 4):
    """(uv (k, 2), response (k,), valid (k,)): at most ``per_cell`` per grid
    cell first, then the rest, each by score; ties by lowest index."""
    h, w = score.shape
    ch, cw = -(-h // cells_y), -(-w // cells_x)
    s = F.pad(score, (0, cw * cells_x - w, 0, ch * cells_y - h))
    cells = s.reshape(cells_y, ch, cells_x, cw).permute(0, 2, 1, 3)
    cells = cells.reshape(cells_y * cells_x, ch * cw)
    rank = _argsort(_argsort(-cells, 1), 1).to(torch.float32)
    rank = torch.where(rank < per_cell, rank, rank + 1024.0)
    key = torch.where(cells > 0, rank * 1e4 - cells,
                      torch.full_like(cells, float("inf")))
    key = key.reshape(cells_y, cells_x, ch, cw).permute(0, 2, 1, 3)
    key = key.reshape(ch * cells_y, cw * cells_x)[:h, :w]
    neg, idx = _stable_topk(-key.reshape(-1), k)
    ys = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    xs = (idx % w).to(torch.float32)
    resp = score.reshape(-1)[idx]
    return torch.stack([xs, ys], -1), resp, torch.isfinite(neg) & (resp > 0)


def subpixel(img, uv, threshold: float):
    """Parabola-vertex offsets (k, 2) from the raw score's 3x3
    neighbourhood at each keypoint."""
    h, w = img.shape
    x0 = torch.clamp(torch.round(uv[:, 0]).long(), 4, w - 5)
    y0 = torch.clamp(torch.round(uv[:, 1]).long(), 4, h - 5)
    offs = torch.arange(-1, 2, device=img.device)
    ys = (y0[:, None, None] + offs[None, :, None]).expand(-1, 3, 3)
    xs = (x0[:, None, None] + offs[None, None, :]).expand(-1, 3, 3)
    centers = img[ys, xs]
    cdx = torch.tensor([d[0] for d in CIRCLE], device=img.device)
    cdy = torch.tensor([d[1] for d in CIRCLE], device=img.device)
    circ = img[torch.clamp(ys[..., None] + cdy, 0, h - 1),
               torch.clamp(xs[..., None] + cdx, 0, w - 1)]
    sp = torch.clamp(torch.maximum(
        _arc_score(circ - centers[..., None] - threshold, -1),
        _arc_score(centers[..., None] - circ - threshold, -1)), min=0.0)
    s0 = sp[:, 1, 1]
    sxm, sxp, sym, syp = sp[:, 1, 0], sp[:, 1, 2], sp[:, 0, 1], sp[:, 2, 1]
    denx = sxm + sxp - 2.0 * s0
    deny = sym + syp - 2.0 * s0
    zero = torch.zeros_like(s0)
    ox = torch.where(denx < -1e-6, (sxm - sxp) / (2.0 * denx), zero)
    oy = torch.where(deny < -1e-6, (sym - syp) / (2.0 * deny), zero)
    return torch.stack([torch.clamp(ox, -0.5, 0.5),
                        torch.clamp(oy, -0.5, 0.5)], -1)


@functools.lru_cache(maxsize=1)
def brief_pattern() -> np.ndarray:
    """(256, 4) int32 [x1 y1 x2 y2]: Gaussian pairs in a radius-13 disc
    from numpy's generator at the program's fixed seed."""
    rng = np.random.default_rng(20240612)
    pts = []
    while len(pts) < NUM_PAIRS * 2:
        cand = rng.normal(0.0, PATTERN_RADIUS / 2.0, size=(NUM_PAIRS, 2))
        cand = np.round(cand).astype(np.int32)
        ok = (cand[:, 0] ** 2 + cand[:, 1] ** 2) <= PATTERN_RADIUS ** 2
        pts.extend(cand[ok].tolist())
    pts = np.asarray(pts[:NUM_PAIRS * 2], dtype=np.int32)
    return np.concatenate([pts[:NUM_PAIRS], pts[NUM_PAIRS:]], axis=1)


def bilinear_patches(img, uv):
    """(k, 31, 31) patches bilinearly resampled at fractional centres
    (zero padding; window starts clamped into the padded image)."""
    pad = PATCH_RADIUS + 2
    p = F.pad(img, (pad, pad, pad, pad))
    ph, pw = p.shape
    base = torch.floor(uv)
    frac = uv - base
    x = torch.clamp(base[:, 0].to(torch.int32).long() + pad - PATCH_RADIUS,
                    0, pw - PATCH - 1)
    y = torch.clamp(base[:, 1].to(torch.int32).long() + pad - PATCH_RADIUS,
                    0, ph - PATCH - 1)
    ar = torch.arange(PATCH + 1, device=img.device)
    q = p[(y[:, None] + ar)[:, :, None], (x[:, None] + ar)[:, None, :]]
    fx = frac[:, 0, None, None]
    fy = frac[:, 1, None, None]
    return (q[:, :-1, :-1] * (1 - fy) * (1 - fx)
            + q[:, :-1, 1:] * (1 - fy) * fx
            + q[:, 1:, :-1] * fy * (1 - fx)
            + q[:, 1:, 1:] * fy * fx)


def angles_and_brief(patches):
    """(angle (k,), desc (k, 8) int32): intensity-centroid angle and the
    unrotated BRIEF words (bit j of word w is pair 32 w + j)."""
    dev = patches.device
    g = np.mgrid[-PATCH_RADIUS:PATCH_RADIUS + 1,
                 -PATCH_RADIUS:PATCH_RADIUS + 1].astype(np.float32)
    yy, xx = np.mgrid[-PATCH_RADIUS:PATCH_RADIUS + 1,
                      -PATCH_RADIUS:PATCH_RADIUS + 1]
    disc = (xx * xx + yy * yy <= PATCH_RADIUS ** 2).astype(np.float32)
    wx = torch.as_tensor((disc * g[1]).reshape(-1), device=dev,
                         dtype=patches.dtype)
    wy = torch.as_tensor((disc * g[0]).reshape(-1), device=dev,
                         dtype=patches.dtype)
    flat = patches.reshape(patches.shape[0], PATCH * PATCH)
    angle = torch.atan2(flat @ wy, flat @ wx)
    pat = brief_pattern()
    i1 = torch.as_tensor((pat[:, 1] + PATCH_RADIUS) * PATCH
                         + pat[:, 0] + PATCH_RADIUS, device=dev).long()
    i2 = torch.as_tensor((pat[:, 3] + PATCH_RADIUS) * PATCH
                         + pat[:, 2] + PATCH_RADIUS, device=dev).long()
    bits = (flat[:, i1] < flat[:, i2]).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    v = torch.sum(bits.reshape(-1, 8, 32) << shifts, -1)
    desc = torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)
    return angle, desc


def extract(frame_u8, params: dict, dtype=torch.float32) -> dict:
    """The reference's features of one uint8 (H, W) frame: ``uv``,
    ``xn`` (pinhole-unprojected), ``response``, ``angle``, ``desc`` and
    ``valid``, each over the program's ``max_features`` slots, computed
    in ``dtype``."""
    img = frame_u8.to(dtype)
    thr = float(params["fast_threshold"])
    score = nms3x3(fast_score(img, thr))
    smooth = blur(img, int(params["gaussian_kernel_size"]))
    uv, resp, valid = select_gridded(score, int(params["max_features"]),
                                     int(params["num_cells_x"]),
                                     int(params["num_cells_y"]))
    uv = uv + subpixel(img, uv, thr) * valid[:, None]
    angle, desc = angles_and_brief(bilinear_patches(smooth, uv))
    fx, fy, cx, cy = (params[k] for k in ("fx", "fy", "cx", "cy"))
    xn = torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], -1)
    return dict(uv=uv, xn=xn, response=resp, angle=angle, desc=desc,
                valid=valid)
