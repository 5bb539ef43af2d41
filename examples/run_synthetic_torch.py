"""Golden path of the PyTorch port: synthetic sequence -> SLAM ->
fossilized trajectory.

The counterpart of ``examples/run_synthetic.py`` on ``mageslam_tpu_torch``:
the host engine ``MageSlamTorch`` at the console's ``fast_settings()``
over ``orbit_trajectory(N, radius=2.0, forward=0.02, sweep=0.9)`` of
``SyntheticWorld.create(700, seed=--seed)`` (render seed 500 + i), one
``process_frame`` per frame, then ``fossilize``.  It prints the tracked
count, keyframes, map points and frames/s, and the Sim(3)-aligned ATE of
the fossilized trajectory (``io/evaluation.ate_rmse``).  The engine runs on
the CUDA card, and raises without one; ``--cpu`` asks for the CPU.

Usage:
  python examples/run_synthetic_torch.py [--frames N] [--cpu] [--csv out.csv]
      [--tum out.tum] [--seed S]

``run(parse_args([...]))`` drives the same code from Python and returns
what it measured.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--cpu", action="store_true",
                    help="run the engine on the CPU instead of the card")
    ap.add_argument("--csv", type=str, default="")
    ap.add_argument("--tum", type=str, default="")
    ap.add_argument("--seed", type=int, default=3)
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """One drive; returns the engine, results, fossil, state codes (0
    skipped, 1 initializing, 2 tracking, 3 relocalizing), tracked count,
    ATE (None under 10 tracked frames) and frames/s."""
    import numpy as np
    from console_torch import fast_settings
    from mageslam_tpu_torch.io.evaluation import ate_rmse
    from mageslam_tpu_torch.io.synthetic import (SyntheticWorld,
                                                 default_calibration,
                                                 orbit_trajectory)
    from mageslam_tpu_torch.runtime.results import (TrackingState,
                                                    state_codes)
    from mageslam_tpu_torch.runtime.slam import MageSlamTorch

    world = SyntheticWorld.create(700, seed=args.seed)
    cal = default_calibration()
    poses_gt = orbit_trajectory(args.frames, radius=2.0, forward=0.02,
                                sweep=0.9)
    engine = MageSlamTorch(fast_settings(), cal, seed=1,
                           device="cpu" if args.cpu else None)

    print(f"[run_synthetic] {args.frames} frames on {engine.device}",
          flush=True)
    results = []
    t0 = time.perf_counter()
    for i, p in enumerate(poses_gt):
        img = world.render(cal, p, seed=500 + i)
        results.append(engine.process_frame(img, timestamp=i / 30.0))
    elapsed = time.perf_counter() - t0

    codes = state_codes(r.state for r in results)
    n_tracked = int((codes == 2).sum())
    fps = len(results) / elapsed
    print(f"tracked {n_tracked}/{len(results)} frames, "
          f"keyframes={engine.num_keyframes}, "
          f"map points={engine.num_map_points}, "
          f"{fps:.1f} frames/s wall")

    fossil = engine.fossilize()
    est, gt = [], []
    for r in results:
        if r.state == TrackingState.TRACKING:
            p = fossil.pose_for_frame(r.frame_id)
            if p is not None:
                est.append(p)
                gt.append(poses_gt[r.frame_id])
    rmse = None
    if len(est) >= 10:
        rmse, _, gt_c = ate_rmse(np.asarray(est), np.asarray(gt))
        extent = float(np.linalg.norm(gt_c.max(0) - gt_c.min(0)))
        print(f"ATE RMSE (Sim3-aligned): {rmse:.4f} m "
              f"({100 * rmse / extent:.2f}% of trajectory extent)")
    if args.csv:
        fossil.export_csv(args.csv)
        print(f"fossil CSV -> {args.csv}")
    if args.tum:
        fossil.export_tum(args.tum)
        print(f"TUM trajectory -> {args.tum}")
    return dict(engine=engine, results=results, fossil=fossil, codes=codes,
                tracked=n_tracked, ate=rmse, fps=fps)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
