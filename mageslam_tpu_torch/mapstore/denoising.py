"""Point-cloud post-processing: normals, mollification, repositioning.

Port of ``mageslam_tpu/mapstore/denoising.py`` (the reference's
Clouds/DeNoising.*, DeNoising.h:13-39: offline normal estimation, normal
mollification and point repositioning for exported clouds; used by VOI and
debug consumers, not by the tracking loop).

Written as the JAX functions are: the k-nearest-neighbour structure is a
dense masked (N, N) distance matrix, its selection goes through
``ops/util.topk`` so ties fall to the lowest index as in ``lax.top_k``;
normals come from batched 3x3 covariance eigendecompositions; the
mollification's ``lax.scan`` is a Python loop.  Everything runs on the
device of the input tensors.  At 8192 points the (N, N, 3) difference is
about 0.8 GB.

An eigenvector's sign is arbitrary in both libraries; the flip toward the
viewing direction fixes it.  A near-degenerate covariance (two smallest
eigenvalues close) can give another eigenvector in either library, so
parity holds for points in general position.
"""

from __future__ import annotations

import torch

from mageslam_tpu_torch.ops import util


def knn_indices(points: torch.Tensor, valid: torch.Tensor,
                k: int = 12) -> torch.Tensor:
    """(N, k) nearest-neighbour indices among valid points (self
    excluded)."""
    diff = points[:, None] - points[None, :]
    # the three squares added in one order on every device (a reduction
    # kernel may pair them otherwise, and a last-bit difference reorders
    # near-equal neighbours)
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
        + diff[..., 2] * diff[..., 2]
    big = 1e12
    n = points.shape[0]
    d2 = torch.where(valid[None, :] & valid[:, None], d2,
                     torch.full_like(d2, big))
    d2 = d2 + torch.eye(n, dtype=d2.dtype, device=d2.device) * big
    return util.topk(-d2, k)[1]


def estimate_normals(points: torch.Tensor, valid: torch.Tensor,
                     view_dirs: torch.Tensor, k: int = 12) -> torch.Tensor:
    """PCA normals oriented toward the viewing direction (DeNoising
    ComputeNormals).  ``view_dirs`` (N, 3): unit camera-to-point directions
    that settle each normal's sign."""
    idx = knn_indices(points, valid, k)
    nbrs = points[idx]                        # (N, k, 3)
    mu = torch.mean(nbrs, dim=1, keepdim=True)
    c = nbrs - mu
    cov = torch.einsum("nka,nkb->nab", c, c) / k
    _, vecs = torch.linalg.eigh(cov)
    normal = vecs[:, :, 0]                    # smallest eigenvector
    flip = torch.sum(normal * view_dirs, dim=-1) > 0
    sign = torch.where(flip, -1.0, 1.0).to(normal.dtype)
    return normal * sign[:, None]


def _neighbour_weights(points, valid, idx, sigma: float):
    d = torch.linalg.vector_norm(points[idx] - points[:, None], dim=-1)
    return torch.exp(-0.5 * (d / sigma) ** 2) * valid[idx].to(d.dtype)


def mollify_normals(points: torch.Tensor, normals: torch.Tensor,
                    valid: torch.Tensor, k: int = 12, sigma: float = 0.1,
                    iters: int = 2) -> torch.Tensor:
    """Smooth the normal field by distance-weighted neighbour averaging
    (DeNoising MollifyNormals)."""
    idx = knn_indices(points, valid, k)
    w = _neighbour_weights(points, valid, idx, sigma)
    for _ in range(iters):
        avg = torch.einsum("nk,nka->na", w, normals[idx]) + normals * 1e-3
        normals = avg / torch.clamp(
            torch.linalg.vector_norm(avg, dim=-1, keepdim=True), min=1e-9)
    return normals


def reposition_points(points: torch.Tensor, normals: torch.Tensor,
                      valid: torch.Tensor, k: int = 12,
                      sigma: float = 0.1) -> torch.Tensor:
    """Move each point onto the weighted average of its neighbours' tangent
    planes (DeNoising RepositionPoints): bilateral denoising that keeps
    structure."""
    idx = knn_indices(points, valid, k)
    nbr_p = points[idx]
    nbr_n = normals[idx]
    w = _neighbour_weights(points, valid, idx, sigma)
    # projection of this point onto each neighbour's tangent plane
    off = torch.einsum("nka,nka->nk", nbr_n, points[:, None] - nbr_p)
    proj = points[:, None] - off[..., None] * nbr_n
    wsum = torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-9)
    new_p = torch.einsum("nk,nka->na", w, proj) / wsum
    return torch.where(valid[:, None], new_p, points)
