#!/usr/bin/env python3
"""Strong and weak scaling of the sharded LM bundle adjustment.

    python3 tools/bench_torch_scaling.py [--shards 1 2 4 8]
        [--landmarks 8192] [--cameras 64] [--steps 8] [--cpu]

The counterpart of ``tools/bench_scaling.py`` for ``mageslam_tpu_torch``.
It times ``parallel/distributed_ba.distributed_bundle_adjust`` (one LM
loop over landmark shards, an ordered gather-sum of the shards' camera
systems per step) on a mesh from ``make_mesh``:

- strong scaling: ``--landmarks`` landmarks in all, cut into n shards;
- weak scaling: ``PER_SHARD`` (1024) landmarks per shard, n times as many
  in all.

Shard i sits on visible card i mod (the card count).  With fewer cards
than shards the shards share a card, so the times show the layout's cost
(n times the launches for 1/n of the work each), not a speed-up; the
printout says which.  The problem: 64 cameras on a line (2 fixed), 12
observations per landmark of ``default_rng(0)``'s draw, projected exactly
and perturbed, as the JAX tool builds it.  Each shard count: the mesh and the
sharded problem are built once (the placement is not timed, as in the JAX
tool), then a warm solve and 5 solves between two device syncs.

The tool measures the card: without one it exits with code 2; ``--cpu``
puts the shards on the CPU (numbers of the CPU, labelled so).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

OBS_PER_POINT = 12
PER_SHARD = 1024
REPS = 5
HUBER, MAX_OUTLIER = 0.007, 0.027


def scaling_problem(K: int, L: int, device=None):
    """The JAX tool's problem, drawn from ``default_rng(0)`` in its order."""
    import torch
    from mageslam_tpu_torch.geometry import se3
    from mageslam_tpu_torch.solvers import pnp
    from mageslam_tpu_torch.solvers.bundle_adjust import (BAProblem,
                                                          empty_tethers)
    rng = np.random.default_rng(0)
    M = OBS_PER_POINT
    pts = np.stack([rng.uniform(-4, 4, L), rng.uniform(-3, 3, L),
                    rng.uniform(4, 12, L)], -1).astype(np.float32)
    poses = torch.stack([se3.make_pose(
        se3.so3_exp(torch.tensor([0.0, 0.02 * k, 0.0])),
        torch.tensor([0.1 * k, 0.0, 0.0])) for k in range(K)])
    obs_kf = np.asarray(rng.integers(0, K, (L, M)), np.int32)
    obs_xn = np.zeros((L, M, 2), np.float32)
    for m_i in range(M):
        xn, _ = pnp.project_normalized(
            poses[torch.as_tensor(obs_kf[:, m_i]).long()],
            torch.as_tensor(pts))
        obs_xn[:, m_i] = xn.numpy()
    obs_xn += rng.normal(0, 5e-4, obs_xn.shape).astype(np.float32)
    noisy = pts + rng.normal(0, 0.05, (L, 3)).astype(np.float32)
    return BAProblem(
        kf_poses=poses.to(device),
        kf_fixed=torch.arange(K, device=device) < 2,
        points=torch.as_tensor(noisy, device=device),
        point_valid=torch.ones(L, dtype=torch.bool, device=device),
        obs_kf=torch.as_tensor(obs_kf, device=device),
        obs_xn=torch.as_tensor(obs_xn, device=device),
        obs_valid=torch.ones((L, M), dtype=torch.bool, device=device),
        **empty_tethers(1, device))


def shard_devices(n: int, cpu: bool = False) -> list:
    """Shard i on visible card i mod the card count (or on the CPU)."""
    import torch
    if cpu:
        return ["cpu"] * n
    cards = torch.cuda.device_count()
    return [f"cuda:{i % cards}" for i in range(n)]


def shard(problem, devices):
    """(mesh, sharded problem): ``problem`` placed on a mesh of ``devices``
    from ``make_mesh``."""
    from mageslam_tpu_torch.parallel import distributed_ba as dba
    mesh = dba.make_mesh(devices=devices)
    return mesh, dba.shard_problem(problem, mesh)


def solve(mesh, sharded, steps: int):
    """``distributed_bundle_adjust`` of a sharded problem on ``mesh``."""
    from mageslam_tpu_torch.parallel import distributed_ba as dba
    return dba.distributed_bundle_adjust(sharded, HUBER, MAX_OUTLIER, mesh,
                                         num_steps=steps)


def clock(problem, devices, steps: int, cuda: bool):
    """(ms per solve, result): the problem sharded once, then a warm solve
    (the result) and ``REPS`` timed ones."""
    from bench_torch import time_calls
    mesh, sharded = shard(problem, devices)
    res = solve(mesh, sharded, steps)
    ms, _ = time_calls(lambda: solve(mesh, sharded, steps), REPS, cuda,
                       warmup=0)
    return ms, res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--landmarks", type=int, default=8192)
    ap.add_argument("--cameras", type=int, default=64)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="shards on the CPU instead of the cards")
    args = ap.parse_args(argv)
    import torch
    if not args.cpu and not torch.cuda.is_available():
        print("bench_torch_scaling: no CUDA device (--cpu measures the "
              "CPU)", file=sys.stderr)
        return 2
    cuda = not args.cpu
    K = args.cameras
    if cuda:
        from bench_torch import gpu_line
        cards = torch.cuda.device_count()
        print(f"devices: {cards} x {gpu_line()}")
    else:
        cards = 1
        print(f"devices: cpu ({torch.get_num_threads()} threads)")
    dev0 = "cuda:0" if cuda else "cpu"
    strong = scaling_problem(K, args.landmarks, dev0)
    t1 = w1 = None
    for n in args.shards:
        devices = shard_devices(n, args.cpu)
        layout = ("one shard per device" if n <= cards else
                  f"{n} shards sharing {min(n, cards)} device(s): the "
                  "layout's cost, not a speed-up")
        ms, res = clock(strong, devices, args.steps, cuda)
        t1 = t1 or ms
        print(f"strong shards={n}: {ms:8.2f} ms/call ({args.steps} LM "
              f"steps, L={args.landmarks}, K={K}) time x{ms / t1:.2f} of 1 "
              f"shard, mse={float(res.mean_sq_error):.3e}; {layout}",
              flush=True)
        weak = scaling_problem(K, PER_SHARD * n, dev0)
        wms, wres = clock(weak, devices, args.steps, cuda)
        w1 = w1 or wms
        print(f"weak shards={n}: {wms:8.2f} ms/call (L={PER_SHARD} "
              f"per shard, {PER_SHARD * n} in all) time x"
              f"{wms / w1:.2f} of 1 shard, mse="
              f"{float(wres.mean_sq_error):.3e}", flush=True)
    payload = ((K + 1) ** 2 * 36 + (K + 1) * 6) * 4
    print(f"per-step reduction payload per shard: {payload / 1024:.0f} KiB "
          f"(independent of the landmark count)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
