"""Write tests/data/torch_parallel.npz: results of the JAX package's
parallel layer (``mageslam_tpu/parallel/``), the goldens of the port's
``mageslam_tpu_torch/parallel/``.

The JAX package runs on its 8-device virtual CPU mesh, as its tests do.
The file holds no frames (the fleet's worlds are rendered again from
their seeds). It holds:

- ``cert_*``: ``multiprocess.run_certification(make_mesh(8))``, the
  in-process certification of 8 shards: the standalone distributed BA's
  poses, points and MSE and the engine-routed global BA's;
- ``map/<field>``: the 100-frame ring map of
  ``tests/test_trajectory_sharding.py``'s ``engine_map`` (the fused
  engine, ``loop_settings()`` with loop closure off, ``fast_settings()``
  capacities: 32 keyframes, 2048 points), with ``map_settings_json`` and
  ``map_cal`` (fx, fy, cx, cy, width, height);
- ``plan<h>_*``: ``plan_from_map(m, 8, halo=2, min_covis=100000)``
  (``h`` = 2) and ``plan_from_map(m, 8, halo=1, min_covis=1)`` (``h`` =
  1): the plan's problem, ``land_perm``, ``block_start``, the dropped
  counts, the tethers and the temporal permutation;
- ``ts_*``: ``trajectory_sharded_global_ba`` on that map with halo 2, 32
  tethers and tether min covisibility 5 over 6 steps: the map's poses and
  points after, the MSE, lambda, inlier count and the info dict;
  ``single_*``: the single-device global BA of the same map, 6 steps;
  ``disp_*``: ``engine_global_bundle_adjust`` with trajectory sharding on
  (minimum 4 keyframes, halo 2, min covisibility 5), 4 steps;
- ``fleet<n>_*``: ``SlamFleet`` drives on the worlds of
  ``tests/test_fleet.py`` (``SyntheticWorld.create(450, seed=20 + i)``,
  ``orbit_trajectory(N, radius=2.0, forward=0.01, sweep=0.5 + 0.05 * i)``,
  frame ``f`` of stream ``i`` rendered with seed ``1000 + 100 i + f``):
  ``fleet4`` is 4 streams x 14 frames at ``fast_settings()``, seed 3, on
  4 of the mesh's devices; ``fleet8`` is 8 streams x 30 frames at
  ``bench.py``'s ``ref_settings()`` (256 keyframes, 8192 points), seed 3.
  Each stores the (streams, frames, 24) output rows, the final keyframe
  and point counts, a CRC-32 of each stream's rendered frames (``crc``)
  and the settings as JSON.  The frames, their CRCs and the seed come
  from the port's ``mageslam_tpu_torch/io/synthetic.py``
  (``fleet_frames``, ``frame_crcs``, ``FLEET_SEED``);
- ``tol/<name>``: the tolerances the port is held to against these
  results (``TOLERANCES``): ``cert_*`` for the certification (poses and
  points absolute, MSE relative), ``ts_*`` for the trajectory-sharded
  solve and the dispatch (poses and points absolute over live slots, MSE
  relative; the solve ends at its error floor, where an LM accept can be
  decided by float32 summation order), ``fleet_tracked`` the frames a
  port stream may track fewer than the JAX one.

Run from the repository root (clear a stale ``.jax_cache`` first):

    JAX_PLATFORMS=cpu python tools/make_torch_parallel_fixture.py

Name parts (``certification``, ``ring_map``, ``fleet_small``,
``fleet_full``) to recompute only those and keep the file's other keys.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
OUT = ROOT / "tests" / "data" / "torch_parallel.npz"
PLANS = {2: dict(halo=2, min_covis=100000), 1: dict(halo=1, min_covis=1)}
TS_HALO, TS_TETHERS, TS_MIN_COVIS, TS_STEPS = 2, 32, 5, 6
DISP_STEPS = 4
TOLERANCES = {"cert_poses": 1e-4, "cert_points": 1e-3, "cert_mse_rel": 1e-3,
              "ts_poses": 2e-3, "ts_points": 1e-2, "ts_mse_rel": 1e-2,
              "fleet_tracked": 3}


def certification(out: dict):
    from mageslam_tpu.parallel import multiprocess as mp
    from mageslam_tpu.parallel.distributed_ba import make_mesh
    res = mp.run_certification(make_mesh(8))
    for k, v in res.items():
        out[f"cert_{k}"] = np.asarray(v)
    print(f"certification: standalone MSE {float(res['standalone_mse']):.3e}"
          f", engine MSE {float(res['engine_mse']):.3e}", flush=True)


def engine_map():
    """The map of ``TestTrajectoryShardingFromEngineMap.engine_map``."""
    import dataclasses

    from mageslam_tpu.io.synthetic import (SyntheticWorld,
                                           default_calibration,
                                           loop_trajectory)
    from mageslam_tpu.runtime.fused import MageSlamTPUFused
    from test_e2e_loop_reloc import loop_settings

    s = loop_settings()
    s = s.replace(loop_closure=dataclasses.replace(
        s.loop_closure, enable_loop_closure=False))
    world = SyntheticWorld.create_ring(900, seed=5)
    cal = default_calibration()
    poses_gt = loop_trajectory(100, radius=3.0, fraction=0.75)
    eng = MageSlamTPUFused(s, cal, seed=1)
    for i, p in enumerate(poses_gt):
        eng.process_frame(world.render(cal, p, seed=100 + i),
                          timestamp=i / 30.0)
    eng.flush()
    eng._settle()
    return eng._state.map, s, cal


def store_plan(out: dict, prefix: str, plan, tethers, perm):
    for f in plan.problem._fields:
        out[f"{prefix}problem/{f}"] = np.asarray(getattr(plan.problem, f))
    for f in ("land_perm", "block_start", "n_dropped_obs",
              "n_dropped_points"):
        out[f"{prefix}{f}"] = np.asarray(getattr(plan, f))
    for f in tethers._fields:
        out[f"{prefix}tethers/{f}"] = np.asarray(getattr(tethers, f))
    out[f"{prefix}perm"] = np.asarray(perm)


def ring_map(out: dict):
    import dataclasses

    import jax.numpy as jnp
    from mageslam_tpu.mapping import global_ba
    from mageslam_tpu.parallel import trajectory_sharding as ts
    from mageslam_tpu.parallel.distributed_ba import make_mesh

    t0 = time.perf_counter()
    m, s, cal = engine_map()
    print(f"ring map: {int(m.kf_valid.sum())} keyframes, "
          f"{int(m.mp_valid.sum())} points "
          f"({time.perf_counter() - t0:.0f} s)", flush=True)
    for f in m._fields:
        out[f"map/{f}"] = np.asarray(getattr(m, f))
    out["map_settings_json"] = np.array(s.to_json())
    out["map_cal"] = np.array([cal.fx, cal.fy, cal.cx, cal.cy, cal.width,
                               cal.height], np.float64)
    for h, kw in PLANS.items():
        plan, tethers, perm = ts.plan_from_map(m, 8, **kw)
        store_plan(out, f"plan{h}_", plan, tethers, perm)
        print(f"plan halo {h}: dropped obs {int(plan.n_dropped_obs)}, "
              f"dropped points {int(plan.n_dropped_points)}, tethers "
              f"{int(tethers.n_pairs)}", flush=True)

    mesh = make_mesh(8)
    fx = float(cal.fx)
    s2 = s.replace(parallel=dataclasses.replace(
        s.parallel, trajectory_halo=TS_HALO,
        trajectory_max_tethers=TS_TETHERS,
        trajectory_tether_min_covis=TS_MIN_COVIS))
    m2, res, info = ts.trajectory_sharded_global_ba(m, s2, fx, mesh,
                                                    num_steps=TS_STEPS)
    out.update(ts_kf_pose=np.asarray(m2.kf_pose),
               ts_mp_pos=np.asarray(m2.mp_pos),
               ts_mse=np.float64(res.mean_sq_error),
               ts_lam=np.float64(res.lam),
               ts_num_inlier_obs=np.int64(res.num_inlier_obs),
               ts_outliers=np.asarray(res.outliers),
               ts_info=np.array([info["n_dropped_obs"],
                                 info["n_dropped_points"],
                                 info["n_tethers"], info["n_shards"]],
                                np.int64))
    px = 1.0 / fx
    m1, res1 = global_ba.global_bundle_adjust(
        m, jnp.float32(s.bundle_adjust.huber_width * px),
        jnp.float32(s.graph_optimization.max_outlier_error * px),
        num_steps=TS_STEPS)
    out.update(single_kf_pose=np.asarray(m1.kf_pose),
               single_mp_pos=np.asarray(m1.mp_pos),
               single_mse=np.float64(res1.mean_sq_error))
    s3 = s.replace(parallel=dataclasses.replace(
        s.parallel, use_trajectory_sharding=True,
        trajectory_min_keyframes=4, trajectory_halo=TS_HALO,
        trajectory_tether_min_covis=TS_MIN_COVIS))
    m3, res3 = global_ba.engine_global_bundle_adjust(
        m, s3, fx, num_steps=DISP_STEPS, lam0=1e-4)
    out.update(disp_kf_pose=np.asarray(m3.kf_pose),
               disp_mp_pos=np.asarray(m3.mp_pos),
               disp_mse=np.float64(res3.mean_sq_error))
    print(f"trajectory-sharded MSE {float(res.mean_sq_error):.4e} "
          f"(single {float(res1.mean_sq_error):.4e}), info {info}; "
          f"dispatch MSE {float(res3.mean_sq_error):.4e}", flush=True)


def fleet_drive(out: dict, prefix: str, n: int, num_frames: int, settings):
    import jax
    from mageslam_tpu.geometry.camera import CameraCalibration
    from mageslam_tpu.parallel.fleet import SlamFleet, default_mesh
    from mageslam_tpu_torch.io.synthetic import (FLEET_SEED, fleet_frames,
                                                 frame_crcs)

    imgs, pcal = fleet_frames(n, num_frames)
    cal = CameraCalibration.pinhole(pcal.fx, pcal.fy, pcal.cx, pcal.cy,
                                    pcal.width, pcal.height)
    assert len(jax.devices()) >= n
    fleet = SlamFleet(settings, cal, mesh=default_mesh(n), seed=FLEET_SEED)
    for f in range(num_frames):
        fleet.process_frames(imgs[f], timestamps=np.full(n, f / 30.0))
    res = fleet.flush()
    rows = np.stack([res[f] for f in range(num_frames)], 1)
    out.update({f"{prefix}_rows": rows.astype(np.float32),
                f"{prefix}_num_keyframes": np.asarray(fleet.num_keyframes),
                f"{prefix}_num_map_points": np.asarray(fleet.num_map_points),
                f"{prefix}_crc": frame_crcs(imgs),
                f"{prefix}_settings_json": np.array(settings.to_json())})
    codes = rows[..., 0].astype(int)
    print(f"{prefix}: tracked per stream {(codes == 2).sum(1).tolist()}, "
          f"keyframes {fleet.num_keyframes.tolist()}", flush=True)
    if not (codes == 2).any(1).all():
        raise SystemExit(f"{prefix}: a stream never tracks")


def fleet_small(out: dict):
    from test_slam_e2e import fast_settings
    fleet_drive(out, "fleet4", 4, 14, fast_settings())


def fleet_full(out: dict):
    from bench import ref_settings
    fleet_drive(out, "fleet8", 8, 30, ref_settings())


PARTS = (certification, ring_map, fleet_small, fleet_full)


def main(names):
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    parts = [p for p in PARTS if p.__name__ in names] if names else PARTS
    if len(parts) != len(names or PARTS):
        raise SystemExit(f"parts: {[p.__name__ for p in PARTS]}")
    out = dict(np.load(OUT)) if names and OUT.exists() else {}
    t_all = time.perf_counter()
    for part in parts:
        t0 = time.perf_counter()
        part(out)
        print(f"{part.__name__}: {time.perf_counter() - t0:.0f} s",
              flush=True)
    out.update({f"tol/{k}": np.float64(v) for k, v in TOLERANCES.items()})
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size / 1e6:.2f} MB) in "
          f"{time.perf_counter() - t_all:.0f} s")


if __name__ == "__main__":
    main(sys.argv[1:])
