"""Keypoint selection from score maps: gridded top-k.

Port of ``mageslam_tpu/ops/select.py``.  Selection keeps JAX's tie order
(stable argsort, top-k ties by lowest index) through ``ops.util``, so the
keypoint sets are identical.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from mageslam_tpu_torch.ops import util


class Keypoints(NamedTuple):
    uv: torch.Tensor        # (K, 2) float32 pixel coords (x, y)
    response: torch.Tensor  # (K,) float32
    valid: torch.Tensor     # (K,) bool


def select_topk(score: torch.Tensor, max_features: int) -> Keypoints:
    """Global top-k keypoints from an NMS'd score map."""
    w = score.shape[1]
    vals, idx = util.topk(score.reshape(-1), max_features)
    ys = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    xs = (idx % w).to(torch.float32)
    return Keypoints(torch.stack([xs, ys], -1), vals, vals > 0)


def select_gridded(score: torch.Tensor, max_features: int,
                   cells_x: int = 32, cells_y: int = 32,
                   per_cell: int = 4) -> Keypoints:
    """Keep <= per_cell best per grid cell (soft cap), then the global
    top-k by (rank within cell, -score)."""
    h, w = score.shape
    ch = -(-h // cells_y)
    cw = -(-w // cells_x)
    s = F.pad(score, (0, cw * cells_x - w, 0, ch * cells_y - h))
    cells = s.reshape(cells_y, ch, cells_x, cw).permute(0, 2, 1, 3)
    cells = cells.reshape(cells_y * cells_x, ch * cw)
    order = util.argsort(-cells, dim=1)
    rank = util.argsort(order, dim=1).to(torch.float32)
    rank = torch.where(rank < per_cell, rank, rank + 1024.0)
    key = torch.where(cells > 0, rank * 1e4 - cells,
                      torch.full_like(cells, float("inf")))
    key_img = key.reshape(cells_y, cells_x, ch, cw).permute(0, 2, 1, 3)
    key_img = key_img.reshape(ch * cells_y, cw * cells_x)[:h, :w]
    neg_key, idx = util.topk(-key_img.reshape(-1), max_features)
    ys = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    xs = (idx % w).to(torch.float32)
    resp = score.reshape(-1)[idx]
    return Keypoints(torch.stack([xs, ys], -1), resp,
                     torch.isfinite(neg_key) & (resp > 0))
