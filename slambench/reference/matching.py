"""Plain reference of tracking's descriptor matching.

A frozen copy of the rules by which tracking matches the local map's
candidates to a frame's features, written out in plain PyTorch:

- a radius match: for each candidate, the feature of least Hamming
  distance among the valid features within ``radius`` pixels of the
  candidate's predicted pixel, kept where that distance is at most
  ``max_distance`` and the second least is at least ``min_difference``
  above it (``argmin`` takes the first least, so indices are exact);
- a unique assignment: where several candidates took one feature, the
  one of least distance keeps it, then the one of lowest index;
- tracking's rounds: a first search at ``search_radius``, widened to
  ``wider_search_radius`` when it finds fewer than
  ``feature_match_threshold`` matches, and to
  ``extra_wider_search_radius`` when still fewer than
  ``min_tracked_feature_count``; after the first pose refinement, a
  search at ``match_search_radius`` around the refined projections for
  the candidates that are not kept inliers of the first refinement.

``pixels`` projects in the dtype of the pose given; the matching itself
is integer logic on the pixels it is handed.  It imports nothing of the
program.
"""

from __future__ import annotations

import torch

from slambench.reference import solvers as rsolve

BIG = 1 << 20
_POP8 = None


def _popcount_bytes(device) -> torch.Tensor:
    global _POP8
    if _POP8 is None or _POP8.device != torch.device(device):
        _POP8 = torch.tensor([bin(i).count("1") for i in range(256)],
                             dtype=torch.int32, device=device)
    return _POP8


def hamming(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """(N, W) x (M, W) int32 descriptor words -> (N, M) int32 distances,
    counted byte by byte through a table."""
    x = torch.bitwise_xor(da[:, None, :], db[None, :, :]).to(torch.int64)
    x = x & 0xFFFFFFFF
    table = _popcount_bytes(da.device)
    total = torch.zeros(x.shape[:2], dtype=torch.int32, device=da.device)
    for shift in (0, 8, 16, 24):
        total = total + table[(x >> shift) & 0xFF].sum(-1, dtype=torch.int32)
    return total


def radius_match(q_uv, q_desc, q_valid, t_uv, t_desc, t_valid,
                 radius: float, max_distance: int, min_difference: int):
    """(idx (N,) int64 into the features or -1, dist (N,) int64)."""
    d2 = ((q_uv[:, None, :].to(torch.float64)
           - t_uv[None, :, :].to(torch.float64)) ** 2).sum(-1)
    ok_pair = (d2 <= float(radius) ** 2) & q_valid[:, None] \
        & t_valid[None, :]
    dm = torch.where(ok_pair, hamming(q_desc, t_desc).to(torch.int64),
                     torch.full(d2.shape, BIG, dtype=torch.int64,
                                device=d2.device))
    idx = torch.argmin(dm, 1)
    best = dm.gather(1, idx[:, None])[:, 0]
    second = dm.scatter(1, idx[:, None], BIG).amin(1)
    ok = (best <= max_distance) & (second - best >= min_difference)
    return (torch.where(ok, idx, torch.full_like(idx, -1)),
            torch.where(ok, best, torch.full_like(best, BIG)))


def assign_unique(idx: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Each feature kept by at most one candidate: least distance, then
    lowest candidate index; the others become -1."""
    idx_l, dist_l = idx.tolist(), dist.tolist()
    taken = {}
    for q, f in enumerate(idx_l):
        if f >= 0 and (f not in taken or (dist_l[q], q) < taken[f]):
            taken[f] = (dist_l[q], q)
    out = [-1] * len(idx_l)
    for f, (_, q) in taken.items():
        out[q] = f
    return torch.tensor(out, dtype=torch.int64, device=idx.device)


def pixels(pose, pts, cal: dict):
    """Predicted pixels (N, 2) and depths (N,) of world points under a
    camera-from-world pose, in the dtype of ``pose``."""
    xn, z = rsolve.project(pose, pts)
    u = xn[:, 0] * cal["fx"] + cal["cx"]
    v = xn[:, 1] * cal["fy"] + cal["cy"]
    return torch.stack([u, v], -1), z


def in_image(uv, cal: dict):
    return ((uv[:, 0] >= 0) & (uv[:, 0] <= cal["width"] - 1)
            & (uv[:, 1] >= 0) & (uv[:, 1] <= cal["height"] - 1))


def track_matches(uv1, uv2, z2, desc_c, c_valid, feats: dict, cal: dict,
                  rules: dict, inliers1) -> dict:
    """Tracking's matches of one frame from its candidates' predicted
    pixels: ``uv1`` under the prior pose for the three first-stage rounds
    (``r1``..``r3``) and the first stage's matches (``m1``); ``uv2`` and
    depths ``z2`` under the first refinement's pose for the second
    stage's search (``r4``) and its matches (``m2``, which keep the first
    stage's matches that ``inliers1`` marks).  Each is (C,) feature
    indices or -1."""

    def search(uv, valid, radius):
        idx, dist = radius_match(uv, desc_c, valid, feats["uv"],
                                 feats["desc"], feats["valid"], radius,
                                 rules["max_distance"],
                                 rules["min_difference"])
        return assign_unique(idx, dist)

    r1 = search(uv1, c_valid, rules["search_radius"])
    r2 = search(uv1, c_valid, rules["wider_search_radius"])
    r3 = search(uv1, c_valid, rules["extra_wider_search_radius"])
    m1 = r1
    if int((m1 >= 0).sum()) < rules["feature_match_threshold"]:
        m1 = r2
    if int((m1 >= 0).sum()) < rules["min_tracked_feature_count"]:
        m1 = r3
    cand2 = c_valid & (z2 > 0) & in_image(uv2, cal)
    r4 = search(uv2, cand2, rules["match_search_radius"])
    keep = (m1 >= 0) & inliers1
    m2 = torch.where(keep, m1, r4)
    return dict(r1=r1, r2=r2, r3=r3, m1=m1, r4=r4, m2=m2, cand2=cand2)
