"""Distributed bundle adjustment over a mesh of landmark shards.

Port of ``mageslam_tpu/parallel/distributed_ba.py``.  The landmark-major
observation table is cut along L into ``mesh.size`` blocks; keyframe poses
and tethers are replicated.  One LM loop runs per process.  Each step:

  - linearizes each local shard on its landmark block (``_error`` and
    ``_build_normal_eq`` of ``solvers/bundle_adjust.py``, no tethers in
    the block) on that shard's device;
  - reduces the shards' (error, S, b) with ``Mesh.reduce``: an ordered sum
    over global shards 0..n-1, the same in one process or across
    ``torch.distributed`` ranks, so every deployment mode gives the same
    bits;
  - adds the replicated tether terms once, after the reduction;
  - solves the (K+1)^2 camera system once and back-substitutes each
    shard's points locally.

``sharded_lm`` is that loop for any shard layout: landmark blocks against
all cameras (here) or against a window of them
(``parallel/trajectory_sharding.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from mageslam_tpu_torch.geometry import se3
from mageslam_tpu_torch.ops import util
from mageslam_tpu_torch.runtime.devices import resolve_device
from mageslam_tpu_torch.solvers import bundle_adjust as ba
from mageslam_tpu_torch.solvers.bundle_adjust import (BAProblem, BAResult,
                                                      empty_tethers)

# the fields of a BAProblem cut along the landmark axis
LANDMARK_FIELDS = ("points", "point_valid", "obs_kf", "obs_xn", "obs_valid")
TETHER_FIELDS = ("tether_i", "tether_j", "tether_type", "tether_pose",
                 "tether_dist", "tether_weight")


class Mesh:
    """The shards over axis ``"shard"`` (JAX's ``Mesh``): ``devices`` are
    the shards this process runs, in global order from ``first``; ``size``
    counts the shards of every process; ``group`` is the
    ``torch.distributed`` group that joins the processes (None in one
    process).  Replicated values live on ``devices[0]``."""

    def __init__(self, devices: Sequence, size: int | None = None,
                 first: int = 0, group=None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        self.size = len(self.devices) if size is None else int(size)
        self.first = int(first)
        self.group = group

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def reduce(self, partials: Sequence[torch.Tensor]) -> torch.Tensor:
        """Sum of one partial per local shard over all global shards, in
        shard order 0..n-1 (one left fold), on ``home``.  Across processes
        the partials are all-gathered first, so every rank folds the same
        operands in the same order as a single process would: the result
        is bit-identical in every deployment mode, which a ring all-reduce
        (another association per rank count) is not."""
        parts = [p.to(self.home) for p in partials]
        if self.group is not None:
            import torch.distributed as dist
            # gloo gathers host tensors: the partials are staged through
            # host memory explicitly (a copy, so no bit changes), which
            # serves CPU ranks and ranks that share one card alike
            local = torch.stack(parts).cpu()
            gathered = [torch.empty_like(local)
                        for _ in range(dist.get_world_size(self.group))]
            dist.all_gather(gathered, local, group=self.group)
            parts = [p.to(self.home) for g in gathered for p in g.unbind(0)]
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The concatenation along dim 0 of every process's local blocks
        (``local`` holds this process's, in shard order), on ``home``."""
        if self.group is None:
            return local.to(self.home)
        import torch.distributed as dist
        staged = local.cpu()
        gathered = [torch.empty_like(staged)
                    for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(gathered, staged, group=self.group)
        return torch.cat(gathered).to(self.home)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh over ``devices`` (this process's shards), or by default one
    shard per visible CUDA card (raises without one, like every entry
    point).  When ``torch.distributed`` is initialized the mesh spans every
    rank's shards: each rank passes its own ``devices`` (the same count on
    every rank) and the global order is rank-major.  ``n_devices`` keeps
    the first ``n_devices`` of the local list."""
    if devices is None:
        resolve_device(None)
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(devices)
    counts = [torch.zeros(1, dtype=torch.int64)
              for _ in range(dist.get_world_size())]
    dist.all_gather(counts, torch.tensor([len(devices)]))
    counts = [int(c) for c in counts]
    if len(set(counts)) != 1:
        raise ValueError(f"every rank needs the same shard count: {counts}")
    rank = dist.get_rank()
    return Mesh(devices, size=sum(counts), first=sum(counts[:rank]),
                group=dist.group.WORLD)


class ShardedProblem(NamedTuple):
    """A BAProblem placed on a mesh (``shard_problem``): ``shards`` are
    this process's landmark blocks, each on its shard's device with its
    own copy of the cameras and no tethers; ``replicated`` holds the
    cameras and tethers on ``mesh.home``, its landmark fields empty."""
    shards: tuple
    replicated: BAProblem


def landmark_block(problem: BAProblem, a: int, b: int, dev, k0: int = 0,
                   kw: int | None = None) -> BAProblem:
    """Landmarks [a, b) of ``problem`` on ``dev`` with the cameras
    [k0, k0 + kw) (all of them by default) and no tethers."""
    kw = problem.kf_poses.shape[0] if kw is None else kw
    return problem._replace(
        kf_poses=problem.kf_poses[k0:k0 + kw].to(dev),
        kf_fixed=problem.kf_fixed[k0:k0 + kw].to(dev),
        **{f: getattr(problem, f)[a:b].to(dev) for f in LANDMARK_FIELDS},
        **empty_tethers(0, dev))


def replicated_part(problem: BAProblem, home) -> BAProblem:
    """The cameras and tethers of ``problem`` on ``home``, its landmark
    fields empty."""
    rep = problem._replace(
        **{f: getattr(problem, f)[:0] for f in LANDMARK_FIELDS})
    return BAProblem(*[x.to(home) for x in rep])


def shard_problem(problem: BAProblem, mesh: Mesh) -> ShardedProblem:
    """Cut the landmark fields into ``mesh.size`` blocks and keep this
    process's, cameras and tethers replicated.  L must divide by the
    shard count (pad with invalid landmarks otherwise).  Every process
    holds the same host data (SPMD) and takes its own blocks."""
    L = problem.points.shape[0]
    n = mesh.size
    if L % n:
        raise ValueError(f"landmark count {L} does not divide by {n} shards")
    per = L // n
    shards = tuple(landmark_block(problem, (mesh.first + i) * per,
                                  (mesh.first + i + 1) * per, dev)
                   for i, dev in enumerate(mesh.devices))
    return ShardedProblem(shards, replicated_part(problem, mesh.home))


def replicated_host_copy(arr: torch.Tensor, mesh: Mesh,
                         sharded: bool = False) -> np.ndarray:
    """Full host copy of a result in both deployment modes.  A replicated
    value (``kf_poses``) is copied as it is; a ``sharded`` one (``points``,
    ``outliers``: this process's landmark blocks) is first gathered from
    every process, so each holds the complete array."""
    if sharded:
        arr = mesh.gather(arr)
    return arr.detach().cpu().numpy()


def sharded_lm(mesh: Mesh, shards: Sequence[BAProblem],
               starts: Sequence[int], replicated: BAProblem, huber_delta,
               max_outlier_error, num_steps: int, lam0) -> BAResult:
    """LM over landmark shards.  Shard ``i`` (a BAProblem without tethers
    whose ``kf_poses`` hold W cameras and whose ``obs_kf`` index them) is
    linearized against ``poses[starts[i]:starts[i] + W]``; its (W+1)^2
    camera system is placed at ``starts[i]`` in the global (K+1)^2 one
    (W = K and start 0 for plain landmark sharding).  ``replicated`` holds
    the K cameras, the fixed mask and the tethers, on ``mesh.home``."""
    home = mesh.home
    hd = float(np.float32(huber_delta))
    moe = float(np.float32(max_outlier_error))
    K = replicated.kf_poses.shape[0]
    W = shards[0].kf_poses.shape[0]
    teth = [getattr(replicated, f) for f in TETHER_FIELDS]

    def window(poses, i):
        return poses.narrow(0, starts[i], W).to(mesh.devices[i])

    def error(poses, points):
        # the shards' robust costs reduced in shard order; the replicated
        # tethers counted once after the reduction (the JAX package scales
        # their weight by 1/n on every shard and sums n copies: the same
        # sum, with less code)
        e = mesh.reduce([ba._error(pr, window(poses, i), points[i], hd)[0]
                         for i, pr in enumerate(shards)])
        return e + ba.tether_error(poses, *teth)

    poses = replicated.kf_poses
    points = [pr.points for pr in shards]
    lam = util.full(lam0, home, torch.float32)
    for _ in range(num_steps):
        err0 = error(poses, points)
        lin, placed = [], []
        for i, pr in enumerate(shards):
            S, b, V_inv, Wb, g_p, kf_safe = ba._build_normal_eq(
                pr, window(poses, i), points[i], hd, lam.to(pr.points.device),
                pose_tethers=False)
            lin.append((V_inv, Wb, g_p, kf_safe))
            # the window's system placed in the global one (its scratch
            # row W dropped; the global scratch row K stays empty)
            a = starts[i]
            SG = S.new_zeros((K + 1, K + 1, 6, 6))
            bG = b.new_zeros((K + 1, 6))
            SG[a:a + W, a:a + W] = S[:W, :W]
            bG[a:a + W] = b[:W]
            placed.append(torch.cat([SG.reshape(-1), bG.reshape(-1)]))
        # one ordered reduction of (S, b): where windows overlap (the
        # trajectory layout's halos) it adds their distinct landmarks'
        # contributions to the shared cameras
        red = mesh.reduce(placed)
        SG = red[:(K + 1) ** 2 * 36].reshape(K + 1, K + 1, 6, 6)
        bG = red[(K + 1) ** 2 * 36:].reshape(K + 1, 6)
        S_t, b_t = ba.tether_normal_contrib(poses, *teth)
        dc = ba._solve_schur(SG + S_t, bG + b_t, replicated.kf_fixed, lam)
        new_poses = se3.pose_retract(poses, dc)
        new_points = []
        for i, (V_inv, Wb, g_p, kf_safe) in enumerate(lin):
            dev = mesh.devices[i]
            dc_pad = torch.cat([dc.narrow(0, starts[i], W),
                                dc.new_zeros((1, 6))]).to(dev)
            Wtdc = torch.einsum("lmbc,lmb->lc", Wb, dc_pad[kf_safe])
            dp = torch.einsum("lbc,lc->lb", V_inv, g_p - Wtdc)
            new_points.append(points[i]
                              + dp * shards[i].point_valid[:, None])
        err1 = error(new_poses, new_points)
        accept = err1 < err0
        poses = torch.where(accept, new_poses, poses)
        points = [torch.where(accept.to(p.device), q, p)
                  for p, q in zip(points, new_points)]
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                          1e-7, 1e3)

    outliers, sums, counts = [], [], []
    for i, pr in enumerate(shards):
        r, good, _ = ba._residuals(pr, window(poses, i), points[i])
        err = torch.sum(r * r, -1)
        out = good & (err > moe ** 2)
        inl = good & ~out
        outliers.append(out)
        sums.append(torch.sum(torch.where(inl, err, torch.zeros_like(err))))
        counts.append(torch.sum(inl))
    n_inl = mesh.reduce(counts)
    mse = mesh.reduce(sums) / torch.clamp(n_inl, min=1)
    return BAResult(poses,
                    torch.cat([p.to(home) for p in points]), mse, lam,
                    torch.cat([o.to(home) for o in outliers]), n_inl)


def distributed_bundle_adjust(problem: ShardedProblem, huber_delta,
                              max_outlier_error, mesh: Mesh,
                              num_steps: int = 5, lam0=1e-4) -> BAResult:
    """LM-BA over landmark blocks (``shard_problem``): collective Schur
    reduction, one camera solve, local back-substitution.  ``kf_poses``,
    ``mean_sq_error``, ``lam`` and ``num_inlier_obs`` are replicated;
    ``points`` and ``outliers`` are this process's blocks in shard
    order."""
    return sharded_lm(mesh, problem.shards, [0] * len(problem.shards),
                      problem.replicated, huber_delta, max_outlier_error,
                      num_steps, lam0)
