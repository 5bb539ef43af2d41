"""Write tests/data/torch_bench.npz: the JAX package's outcomes on the
fixtures of ``bench.py`` and ``examples/run_synthetic.py``, the goldens of
the port's ``bench_torch.py`` and ``examples/run_synthetic_torch.py``.

The file holds no frames: the port renders them with its own copy of
``io/synthetic.py``, and the CRC-32 of each frame is stored so that a host
without JAX can check that it rendered the same ones.  It holds:

- ``bench_crcs`` (250,): the CRC-32 of each of ``bench.py``'s frames
  (``SyntheticWorld.create(700, seed=3)``, ``orbit_trajectory(250,
  radius=2.0, forward=0.0032, sweep=0.9)``, render seed 500 + i);
- ``bench_<name>_codes`` (250,) for ``name`` in ``ref`` (``bench.py``'s
  ``ref_settings()``) and ``fast`` (``fast_settings()`` of
  ``tests/test_slam_e2e.py``, ``MAGESLAM_BENCH_FAST``): the per-frame
  state codes (0 skipped, 1 initializing, 2 tracking, 3 relocalizing) of
  one bench drive of ``MageSlamTPUFused(settings, cal, seed=1)``:
  ``reset(seed=1)``, the 50 warm-up frames through ``process_sequence``
  and ``flush``, then the 200 timed frames; ``bench_<name>_settings_json``;
- ``rs_*``: ``examples/run_synthetic.py`` at its default arguments (the
  host engine ``MageSlamTPU`` at ``fast_settings()``, world seed 3, 60
  frames of ``orbit_trajectory(60, radius=2.0, forward=0.02, sweep=0.9)``,
  render seed 500 + i): ``rs_codes`` (60,), ``rs_tracked``, ``rs_ate``
  (the Sim3-aligned ATE that the script prints, computed the same way),
  ``rs_keyframes``, ``rs_map_points`` and ``rs_settings_json``.

Run from the repository root (JAX on the CPU):

    JAX_PLATFORMS=cpu python tools/make_torch_bench_fixture.py [part ...]

Parts are ``bench_ref``, ``bench_fast``, ``init_seeds`` and
``run_synthetic``; naming some
recomputes only those and keeps the file's other keys.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
OUT = ROOT / "tests" / "data" / "torch_bench.npz"
N_FRAMES, WARMUP = 250, 50
RS_FRAMES = 60
PARTS = ("bench_ref", "bench_fast", "init_seeds", "run_synthetic")


def state_codes(states) -> np.ndarray:
    from mageslam_tpu.runtime.slam import TrackingState
    order = [TrackingState.SKIPPED, TrackingState.INITIALIZING,
             TrackingState.TRACKING, TrackingState.RELOCALIZING]
    return np.array([order.index(s) for s in states], np.int8)


def bench_frames():
    from mageslam_tpu.io.synthetic import (SyntheticWorld,
                                           default_calibration,
                                           orbit_trajectory)
    cal = default_calibration()
    world = SyntheticWorld.create(700, seed=3)
    poses = orbit_trajectory(N_FRAMES, radius=2.0, forward=0.0032, sweep=0.9)
    return [world.render(cal, p, seed=500 + i)
            for i, p in enumerate(poses)], cal


def bench_drive(name: str, imgs, cal) -> dict:
    """One drive of bench.py's main loop."""
    from mageslam_tpu.runtime.fused import MageSlamTPUFused
    if name == "ref":
        from bench import ref_settings
        settings = ref_settings()
    else:
        from test_slam_e2e import fast_settings
        settings = fast_settings()
    ts = [i / 30.0 for i in range(N_FRAMES)]
    eng = MageSlamTPUFused(settings, cal, seed=1)
    eng.reset(seed=1)
    eng.process_sequence(imgs[:WARMUP], ts[:WARMUP])
    eng.flush()
    eng.process_sequence(imgs[WARMUP:], ts[WARMUP:])
    results = eng.flush()
    codes = state_codes([results[i].state for i in range(N_FRAMES)])
    first = int(np.argmax(codes == 2)) if (codes == 2).any() else -1
    print(f"bench {name}: tracked {int((codes == 2).sum())}/{N_FRAMES} "
          f"(timed frames {int((codes[WARMUP:] == 2).sum())}), first "
          f"tracking frame {first}", flush=True)
    return {f"bench_{name}_codes": codes,
            f"bench_{name}_settings_json": np.array(settings.to_json())}


def init_seeds(imgs, cal) -> dict:
    """The first tracking frame over bench.py's first frames at
    fast_settings(), one drive from reset(seed) for each seed."""
    from bench_torch import INIT_FRAMES, INIT_SEEDS
    from mageslam_tpu.runtime.fused import MageSlamTPUFused
    from test_slam_e2e import fast_settings
    imgs = imgs[:INIT_FRAMES]
    ts = [i / 30.0 for i in range(INIT_FRAMES)]
    eng = MageSlamTPUFused(fast_settings(), cal, seed=1)
    firsts = []
    for seed in INIT_SEEDS:
        eng.reset(seed=seed)
        eng.process_sequence(imgs, ts)
        results = eng.flush()
        codes = state_codes([results[i].state for i in range(INIT_FRAMES)])
        firsts.append(int(np.argmax(codes == 2)) if (codes == 2).any()
                      else -1)
    print(f"init seeds {list(INIT_SEEDS)}: first tracking frames {firsts}",
          flush=True)
    return {"init_seeds": np.array(INIT_SEEDS, np.int64),
            "init_first": np.array(firsts, np.int64)}


def run_synthetic() -> dict:
    """examples/run_synthetic.py at its defaults, its numbers kept."""
    from mageslam_tpu.io.evaluation import ate_rmse
    from mageslam_tpu.io.synthetic import (SyntheticWorld,
                                           default_calibration,
                                           orbit_trajectory)
    from mageslam_tpu.runtime.slam import MageSlamTPU, TrackingState
    from test_slam_e2e import fast_settings

    world = SyntheticWorld.create(700, seed=3)
    cal = default_calibration()
    poses_gt = orbit_trajectory(RS_FRAMES, radius=2.0, forward=0.02,
                                sweep=0.9)
    settings = fast_settings()
    engine = MageSlamTPU(settings, cal, seed=1)
    results = [engine.process_frame(world.render(cal, p, seed=500 + i),
                                    timestamp=i / 30.0)
               for i, p in enumerate(poses_gt)]
    fossil = engine.fossilize()
    est, gt = [], []
    for r in results:
        if r.state == TrackingState.TRACKING:
            p = fossil.pose_for_frame(r.frame_id)
            if p is not None:
                est.append(p)
                gt.append(poses_gt[r.frame_id])
    rmse, _, _ = ate_rmse(np.asarray(est), np.asarray(gt))
    codes = state_codes([r.state for r in results])
    out = {"rs_codes": codes, "rs_tracked": np.int64((codes == 2).sum()),
           "rs_ate": np.float64(rmse),
           "rs_keyframes": np.int64(engine.num_keyframes),
           "rs_map_points": np.int64(engine.num_map_points),
           "rs_settings_json": np.array(settings.to_json())}
    print(f"run_synthetic: tracked {int(out['rs_tracked'])}/{RS_FRAMES}, "
          f"ATE {rmse:.4f}, keyframes {engine.num_keyframes}, map points "
          f"{engine.num_map_points}", flush=True)
    return out


def main(parts) -> None:
    import jax
    from bench_torch import frame_crcs
    jax.config.update("jax_platforms", "cpu")
    out = {}
    if OUT.exists() and set(parts) != set(PARTS):
        with np.load(OUT) as z:
            out = {k: z[k] for k in z.files}
    if set(parts) & {"bench_ref", "bench_fast", "init_seeds"}:
        imgs, cal = bench_frames()
        out["bench_crcs"] = frame_crcs(imgs)
        for p in parts:
            t0 = time.perf_counter()
            if p.startswith("bench_"):
                out.update(bench_drive(p[len("bench_"):], imgs, cal))
            elif p == "init_seeds":
                out.update(init_seeds(imgs, cal))
            else:
                continue
            print(f"  {time.perf_counter() - t0:.0f} s", flush=True)
    if "run_synthetic" in parts:
        t0 = time.perf_counter()
        out.update(run_synthetic())
        print(f"  {time.perf_counter() - t0:.0f} s", flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size / 1e3:.1f} kB)")


if __name__ == "__main__":
    parts = sys.argv[1:] or list(PARTS)
    unknown = set(parts) - set(PARTS)
    if unknown:
        raise SystemExit(f"unknown parts {sorted(unknown)}; "
                         f"choose from {PARTS}")
    main(parts)
