"""Keyframe-block trajectory sharding with halo exchange.

Port of ``mageslam_tpu/parallel/trajectory_sharding.py``.  The trajectory
is cut into ``n`` contiguous keyframe blocks, one per shard, in frame
order; a landmark lives with the block of its anchoring (first observing)
keyframe, and each shard linearizes only observations whose camera falls
inside its window: the block plus ``halo`` keyframes on each side.  The
window systems are placed into the banded (K+1)^2 global system and
assembled by the mesh's ordered reduction (the halo exchange,
``distributed_ba.sharded_lm``); the camera solve runs once and each shard
back-substitutes its points.

Observations outside their landmark's window are masked out and counted
(``n_dropped_obs``).  ``plan_from_map`` re-injects the strongest of those
long-range couplings as replicated SIX_DOF tethers (``LongRangeTethers``)
added after the reduction.

Integer outputs hold the JAX package's exactly: argsorts and the tether
top-k go through ``ops/util`` (stable, ties by lowest index; the
covisibility matrix is full of ties), ``searchsorted`` is side-left, and
the first observation is the first True.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mageslam_tpu_torch.geometry import se3
from mageslam_tpu_torch.mapstore import map_state as ms
from mageslam_tpu_torch.ops import util
from mageslam_tpu_torch.parallel.distributed_ba import (Mesh,
                                                        landmark_block,
                                                        replicated_part,
                                                        sharded_lm)
from mageslam_tpu_torch.solvers.bundle_adjust import (TETHER_SIX_DOF,
                                                      BAProblem, BAResult,
                                                      empty_tethers)

class TrajectoryShardPlan(NamedTuple):
    """Static partition of a BAProblem by trajectory blocks."""
    problem: BAProblem         # landmark-reordered, window-LOCAL obs_kf
    land_perm: torch.Tensor    # (L,) original landmark id per slot, -1 pad
    block_start: torch.Tensor  # (n,) first keyframe of each block window
    n_dropped_obs: torch.Tensor    # observations outside any window
    n_dropped_points: torch.Tensor  # landmarks beyond a block's capacity


class LongRangeTethers(NamedTuple):
    """Replicated SIX_DOF tethers standing in for the observations the
    windows drop (loop seams), at the current relative pose, weighted by
    the shared-observation count they replace."""
    i: torch.Tensor       # (T,) int32 temporal keyframe index
    j: torch.Tensor       # (T,) int32
    ttype: torch.Tensor   # (T,) int32 (0 = disabled slot)
    pose: torch.Tensor    # (T, 7) target relative pose T_i * T_j^-1
    dist: torch.Tensor    # (T,)
    weight: torch.Tensor  # (T,)
    n_pairs: torch.Tensor  # () live tether count


def _sizes(K: int, L: int, n: int, halo: int):
    if K % n or L % n:
        raise ValueError(f"K={K} and L={L} must divide by {n} shards")
    B = K // n
    return B, min(B + 2 * halo, K), L // n


def plan_trajectory_shards(problem: BAProblem, n_shards: int,
                           halo: int) -> TrajectoryShardPlan:
    """Reorder landmarks by anchor block and make ``obs_kf`` window-local.

    Block b owns keyframes [b B, (b+1) B); its window spans
    [b B - halo, b B - halo + B + 2 halo) clipped into [0, K).  A landmark
    is anchored at its first valid observation's keyframe and binned to
    that block; blocks are padded to L / n slots.  Out-of-window
    observations are invalidated and counted."""
    K = problem.kf_poses.shape[0]
    L = problem.obs_kf.shape[0]
    n = n_shards
    B, W, per = _sizes(K, L, n, halo)
    dev = problem.points.device
    ar = torch.arange(L, device=dev)

    first_obs = util.first_true(problem.obs_valid, 1)
    anchor = problem.obs_kf[ar, first_obs].long()
    has_obs = problem.obs_valid.any(1) & problem.point_valid
    block = torch.clamp(anchor // B, 0, n - 1)
    block = torch.where(has_obs, block, torch.full_like(block, n - 1))

    order = util.argsort(block * (L + 1) + ar)
    blk_sorted = block[order].contiguous()
    rank = ar - torch.searchsorted(blk_sorted, blk_sorted, right=False)
    keep = rank < per
    slot = blk_sorted * per + torch.clamp(rank, 0, per - 1)
    # dropped entries go to the scratch slot L, cut off after: no two live
    # writes share an index
    land_perm = torch.full((L + 1,), -1, dtype=torch.int32, device=dev)
    land_perm[torch.where(keep, slot, torch.full_like(slot, L))] = \
        torch.where(keep, order, torch.full_like(order, -1)).to(torch.int32)
    land_perm = land_perm[:L]
    src = torch.clamp(land_perm, 0, L - 1).long()
    sel_ok = land_perm >= 0
    n_dropped_points = has_obs.sum() - (sel_ok & has_obs[src]).sum()

    start = torch.clamp(torch.arange(n, device=dev) * B - halo, 0, K - W)
    my_start = start[ar // per]
    local = problem.obs_kf[src].long() - my_start[:, None]
    in_win = (local >= 0) & (local < W)
    obs_valid = problem.obs_valid[src] \
        & problem.point_valid[src][:, None] & sel_ok[:, None]
    n_dropped = (obs_valid & ~in_win).sum()
    obs_valid = obs_valid & in_win

    new_problem = problem._replace(
        points=problem.points[src],
        point_valid=problem.point_valid[src] & sel_ok,
        obs_kf=torch.clamp(local, 0, W - 1).to(torch.int32),
        obs_xn=problem.obs_xn[src],
        obs_valid=obs_valid,
        **empty_tethers(1, dev))
    return TrajectoryShardPlan(new_problem, land_perm,
                               start.to(torch.int32), n_dropped,
                               n_dropped_points)


def empty_long_range_tethers(t: int = 1, device=None) -> LongRangeTethers:
    return LongRangeTethers(
        i=torch.zeros(t, dtype=torch.int32, device=device),
        j=torch.zeros(t, dtype=torch.int32, device=device),
        ttype=torch.zeros(t, dtype=torch.int32, device=device),
        pose=se3.pose_identity(device).expand(t, 7).clone(),
        dist=torch.zeros(t, dtype=torch.float32, device=device),
        weight=torch.zeros(t, dtype=torch.float32, device=device),
        n_pairs=torch.zeros((), dtype=torch.int32, device=device))


def trajectory_block_bundle_adjust(plan: TrajectoryShardPlan, huber_delta,
                                   max_outlier_error, mesh: Mesh, halo: int,
                                   num_steps: int = 5, lam0=1e-4,
                                   tethers: LongRangeTethers | None = None
                                   ) -> BAResult:
    """LM-BA over trajectory blocks: each shard linearizes its landmark
    block on its W-keyframe window; the banded camera system is assembled
    by one ordered reduction per iteration, the long-range tethers added
    after it; one camera solve; local back-substitution.

    Returns a BAResult in the PLAN's landmark order (``points`` and
    ``outliers`` for this process's blocks; scatter back with
    ``plan.land_perm``)."""
    problem = plan.problem
    K = problem.kf_poses.shape[0]
    L = problem.points.shape[0]
    n = mesh.size
    _, W, per = _sizes(K, L, n, halo)
    if tethers is None:
        tethers = empty_long_range_tethers(1, mesh.home)
    starts = plan.block_start.tolist()
    local = [mesh.first + i for i in range(len(mesh.devices))]
    shards = [landmark_block(problem, g * per, (g + 1) * per, dev,
                             starts[g], W)
              for g, dev in zip(local, mesh.devices)]
    local_starts = [starts[g] for g in local]
    replicated = replicated_part(problem._replace(
        tether_i=tethers.i, tether_j=tethers.j, tether_type=tethers.ttype,
        tether_pose=tethers.pose, tether_dist=tethers.dist,
        tether_weight=tethers.weight), mesh.home)
    return sharded_lm(mesh, shards, local_starts, replicated, huber_delta,
                      max_outlier_error, num_steps, lam0)


# ---------------------------------------------------------------------------
# Engine wiring: MapState -> plan -> sharded solve -> MapState
# ---------------------------------------------------------------------------


def plan_from_map(m: ms.MapState, n_shards: int, halo: int,
                  max_obs_per_point: int = 12, max_tethers: int = 64,
                  min_covis: int = 8, tether_weight_scale: float = 1.0):
    """A trajectory-sharded plan of an engine map.

    Keyframe slots recycle out of temporal order after culling, so the
    blocks are formed over a temporal permutation of the slots (by
    ``kf_frame_id``; dead slots sort last and pad the final block).
    Strongly covisible keyframe pairs too far apart for any window become
    replicated SIX_DOF tethers at their current relative pose, weighted by
    their shared-observation count.

    Returns (plan, tethers, perm), ``perm[temporal index] = slot``."""
    from mageslam_tpu_torch.mapping.global_ba import build_global_problem

    win = build_global_problem(m, max_obs_per_point)
    problem = win.problem
    K = problem.kf_poses.shape[0]
    dev = problem.points.device
    fidkey = torch.where(m.kf_valid, m.kf_frame_id,
                         torch.full_like(m.kf_frame_id, 2 ** 30))
    perm = util.argsort(fidkey)
    inv = torch.empty(K, dtype=torch.int64, device=dev)
    inv[perm] = torch.arange(K, device=dev)
    problem_t = problem._replace(
        kf_poses=problem.kf_poses[perm], kf_fixed=problem.kf_fixed[perm],
        obs_kf=inv[problem.obs_kf.long()].to(torch.int32))
    plan = plan_trajectory_shards(problem_t, n_shards, halo)

    _, W, _ = _sizes(K, problem.points.shape[0], n_shards, halo)
    cov = ms.covisibility(m)[perm][:, perm]
    validT = m.kf_valid[perm]
    ii = torch.arange(K, device=dev)
    # a reference defect, ported as it is (ADVICE.md r5, the JAX
    # package's trajectory_sharding.py:330): only pairs at least W apart
    # in temporal order become tethers, but the windows are anchored at
    # block starts, not sliding, so a covisible pair closer than W that
    # straddles a block boundary can share no window: its observations
    # are dropped and no tether replaces them
    far = (ii[None, :] - ii[:, None]) >= W
    wmat = torch.where(far & validT[:, None] & validT[None, :], cov,
                       torch.zeros_like(cov))
    vals, idx = util.topk(wmat.reshape(-1), max_tethers)
    ti = idx // K
    tj = idx % K
    live = vals >= min_covis
    kfT = problem_t.kf_poses
    rel = se3.pose_compose(kfT[ti], se3.pose_inverse(kfT[tj]))
    zero = torch.zeros_like(ti)
    tethers = LongRangeTethers(
        i=torch.where(live, ti, zero).to(torch.int32),
        j=torch.where(live, tj, zero).to(torch.int32),
        ttype=torch.where(live, torch.full_like(ti, TETHER_SIX_DOF),
                          zero).to(torch.int32),
        pose=rel,
        dist=torch.zeros(max_tethers, dtype=torch.float32, device=dev),
        weight=torch.where(live, vals.to(torch.float32)
                           * tether_weight_scale,
                           torch.zeros_like(vals, dtype=torch.float32)),
        n_pairs=live.sum().to(torch.int32))
    return plan, tethers, perm.to(torch.int32)


def apply_plan_result(m: ms.MapState, plan: TrajectoryShardPlan,
                      res: BAResult, perm: torch.Tensor) -> ms.MapState:
    """Scatter a trajectory-sharded BAResult (all landmark blocks) back
    into the map: poses leave temporal order through ``perm``, points the
    plan's landmark order through ``plan.land_perm``."""
    K = perm.shape[0]
    dev = m.kf_pose.device
    inv = torch.empty(K, dtype=torch.int64, device=dev)
    inv[perm.long()] = torch.arange(K, device=dev)
    L = plan.land_perm.shape[0]
    mp_ok = (plan.land_perm >= 0) & plan.problem.point_valid
    return ms.apply_ba_update(
        m, torch.arange(K, dtype=torch.int32, device=dev), m.kf_valid,
        res.kf_poses.to(dev)[inv], torch.clamp(plan.land_perm, 0, L - 1),
        mp_ok, res.points.to(dev))


def trajectory_sharded_global_ba(m: ms.MapState, settings, fx: float,
                                 mesh: Mesh, num_steps: int = 10,
                                 lam0=1e-4):
    """Plan, solve and write back at the settings' halo and tether limits.
    Returns (map, BAResult, info dict).  The engine's global-BA dispatch
    routes here when ``use_trajectory_sharding`` is on and the live
    keyframes reach ``trajectory_min_keyframes``."""
    px = 1.0 / fx
    p = settings.parallel
    n = mesh.size
    plan, tethers, perm = plan_from_map(
        m, n, int(p.trajectory_halo),
        max_tethers=int(p.trajectory_max_tethers),
        min_covis=int(p.trajectory_tether_min_covis))
    res = trajectory_block_bundle_adjust(
        plan, np.float32(settings.bundle_adjust.huber_width * px),
        np.float32(settings.graph_optimization.max_outlier_error * px),
        mesh, int(p.trajectory_halo), num_steps=num_steps, lam0=lam0,
        tethers=tethers)
    m2 = apply_plan_result(m, plan, res._replace(
        points=mesh.gather(res.points)), perm)
    info = {
        "n_dropped_obs": int(plan.n_dropped_obs),
        "n_dropped_points": int(plan.n_dropped_points),
        "n_tethers": int(tethers.n_pairs),
        "n_shards": n,
    }
    return m2, res, info
