"""Multi-process distributed execution harness.

Port of ``mageslam_tpu/parallel/multiprocess.py``.  Every process runs the
same program; the mesh spans the processes' shards
(``distributed_ba.make_mesh`` under an initialized ``torch.distributed``
group) and the one collective of each LM step, the ordered gather-sum of
``Mesh.reduce``, crosses processes through gloo.  Gloo serves CPU ranks
and ranks that share one card alike (NCCL refuses two ranks on one GPU).

  - ``init_multiprocess`` + ``worker_main``: the per-process entry.  A
    worker joins the group, forms the global mesh over its local shards
    and every other rank's, and runs (a) the standalone distributed BA and
    (b) the engine-routed global BA
    (``mapping.global_ba.engine_global_bundle_adjust``, the fossilize /
    loop-closure path) on a deterministic certification map, then writes
    its results to an npz for the launcher.
  - ``spawn_certification``: the launcher.  Spawns the workers
    (``python -m mageslam_tpu_torch.parallel.multiprocess``) against a
    local coordinator, waits, and checks that every process produced
    identical results.  The ordered reduction makes them identical to an
    in-process run on a mesh of the same global size as well.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch

CERT_SEED = 7
CERT_K = 6          # keyframes in the certification map
CERT_NPOINTS = 96   # live landmarks
CERT_L = 512        # landmark capacity (divisible by any shard count <= 32)
RESULT_KEYS = ("standalone_poses", "standalone_points", "engine_poses",
               "engine_points")


def init_multiprocess(coordinator: str, num_processes: int,
                      process_id: int, device=None) -> None:
    """Join the process group at ``tcp://<coordinator>`` over gloo.  On the
    card, float32 products stay full precision (no TF32), as in the
    facades, so every rank computes what a single process would."""
    import torch.distributed as dist
    if device is not None and torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def certification_map(settings=None, device=None):
    """Deterministic small map and settings for the certification, built
    identically in every process (each takes its own blocks) and in the
    single-process reference run.  Its numpy draws are the JAX package's,
    so both packages build the same map."""
    import dataclasses

    from mageslam_tpu_torch.config import MageSlamSettings
    from mageslam_tpu_torch.geometry import se3
    from mageslam_tpu_torch.mapstore import map_state as ms
    from mageslam_tpu_torch.solvers import pnp
    from mageslam_tpu_torch.tracking.frontend import FrameFeatures

    rng = np.random.default_rng(CERT_SEED)
    if settings is None:
        settings = MageSlamSettings()
    s = settings.replace(capacity=settings.capacity.__class__(
        max_features=128, max_keyframes=16, max_map_points=CERT_L,
        local_ba_keyframes=4, local_ba_points=128, pose_history_size=64))
    s = s.replace(parallel=dataclasses.replace(
        s.parallel, use_distributed_global_ba=True, min_devices=2))

    def T(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=device)

    n = CERT_NPOINTS
    m = ms.empty_map(16, 128, CERT_L, device)
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(4, 8, n)], -1).astype(np.float32)
    normal = (pts / np.linalg.norm(pts, axis=-1, keepdims=True)
              ).astype(np.float32)
    desc = rng.integers(0, 2**32, (128, 8), dtype=np.uint32).view(np.int32)
    m, ids = ms.allocate_map_points(
        m, T(pts), T(desc[:n]), T(normal), 0,
        torch.ones(n, dtype=torch.bool, device=device))
    F = 128
    for k in range(CERT_K):
        pose = se3.make_pose(se3.so3_exp(T([0.0, 0.03 * k, 0.0],
                                           torch.float32)),
                             T([0.2 * k, 0.0, 0.0], torch.float32))
        xn, _ = pnp.project_normalized(pose, T(pts))
        xn_noisy = xn + T(rng.normal(0, 3e-4, (n, 2)).astype(np.float32))
        uv = torch.zeros((F, 2), device=device)
        uv[:n] = xn * 272.0 + 160.0
        xu = torch.zeros((F, 2), device=device)
        xu[:n] = xn_noisy
        feats = FrameFeatures(
            uv=uv, xn_undist=xu, response=torch.ones(F, device=device),
            angle=torch.zeros(F, device=device),
            octave=torch.zeros(F, dtype=torch.int32, device=device),
            desc=T(desc), valid=torch.arange(F, device=device) < n)
        assoc = torch.full((F,), -1, dtype=torch.int32, device=device)
        assoc[:n] = ids
        m, _ = ms.insert_keyframe(m, pose, feats, assoc, k)
    return m, s


def run_certification(mesh=None):
    """The certification body: the standalone distributed BA and the
    engine-routed global BA over ``mesh`` (default ``make_mesh()``).
    Returns a dict of numpy results, identical on every process if the
    distributed path is right."""
    from mageslam_tpu_torch.mapping import global_ba
    from mageslam_tpu_torch.parallel import distributed_ba as dba

    if mesh is None:
        mesh = dba.make_mesh()
    m, s = certification_map(device=mesh.home)

    # (a) standalone collective-Schur LM over the global problem
    win = global_ba.build_global_problem(m)
    sp = dba.shard_problem(win.problem, mesh)
    res = dba.distributed_bundle_adjust(
        sp, np.float32(0.01), np.float32(0.02), mesh, num_steps=6)

    # (b) the engine-routed path (fossilize / loop-closure dispatch)
    m2, res2 = global_ba.engine_global_bundle_adjust(
        m, s, 272.0, num_steps=6, lam0=1e-4, mesh=mesh)

    return {
        "standalone_poses": dba.replicated_host_copy(res.kf_poses, mesh),
        "standalone_points": dba.replicated_host_copy(res.points, mesh,
                                                      sharded=True),
        "standalone_mse": np.float64(res.mean_sq_error),
        "engine_poses": m2.kf_pose.cpu().numpy(),
        "engine_points": m2.mp_pos.cpu().numpy(),
        "engine_mse": np.float64(res2.mean_sq_error),
        "n_global_devices": np.int64(mesh.size),
    }


def worker_main(argv=None) -> int:
    import argparse

    import torch.distributed as dist

    from mageslam_tpu_torch.parallel.distributed_ba import make_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-devices", type=int, required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--num-threads", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    # the launcher's thread count: CPU reductions may split their work by
    # it, and the in-process reference run uses the launcher's
    torch.set_num_threads(args.num_threads)
    init_multiprocess(args.coordinator, args.num_processes,
                      args.process_id, args.device)
    try:
        mesh = make_mesh(devices=[args.device] * args.local_devices)
        print(f"worker {args.process_id}: local={len(mesh.devices)} "
              f"global={mesh.size} processes={dist.get_world_size()}",
              flush=True)
        out = run_certification(mesh)
        np.savez(args.out, **out)
    finally:
        dist.destroy_process_group()
    print(f"worker {args.process_id}: wrote {args.out}", flush=True)
    return 0


def spawn_certification(num_processes: int = 2, local_devices: int = 4,
                        timeout: float = 600.0, device=None):
    """Spawn the workers, collect their results, check that the processes
    agree bit for bit, and return (per-process result dicts, logs).  The
    workers' shards go on ``device`` (the card unless the caller passes
    ``"cpu"``).  Raises on a nonzero exit, a timeout or a mismatch."""
    from mageslam_tpu_torch.runtime.devices import resolve_device
    dev = str(resolve_device(device))
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    coord = f"localhost:{port}"
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory(prefix="mageslam_mp_") as tmpdir:
        outs = [os.path.join(tmpdir, f"worker{i}.npz")
                for i in range(num_processes)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "mageslam_tpu_torch.parallel.multiprocess",
             "--coordinator", coord, "--num-processes", str(num_processes),
             "--process-id", str(i), "--local-devices", str(local_devices),
             "--device", dev, "--num-threads", str(torch.get_num_threads()),
             "--out", outs[i]],
            cwd=repo_root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for i in range(num_processes)]
        logs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=timeout)
                logs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for i, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"worker {i} exited rc={p.returncode}:\n"
                                   f"{logs[i][-4000:]}")
        results = []
        for o in outs:
            with np.load(o) as z:
                results.append(dict(z))
    r0 = results[0]
    for i, r in enumerate(results[1:], 1):
        for key in RESULT_KEYS + ("standalone_mse", "engine_mse"):
            if not np.array_equal(r0[key], r[key]):
                d = float(np.max(np.abs(r0[key] - r[key])))
                raise AssertionError(
                    f"process 0 vs {i} disagree on {key} (max |d|={d:g}): "
                    "every process must produce identical results")
    return results, logs


if __name__ == "__main__":
    sys.exit(worker_main())
