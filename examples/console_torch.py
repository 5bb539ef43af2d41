"""Console app of the PyTorch port: dataset -> SLAM -> fossilized trajectory.

The golden path of ``examples/console.py`` on ``mageslam_tpu_torch``:
frames come off disk through the port's ``FramePump`` (or from the
synthetic world), go one by one into ``MageSlamTorchFused`` (with
``--host-engine``, the host-orchestrated ``MageSlamTorch``), and
``fossilize`` gives the trajectory, written as the fossil CSV (4x4
world-from-camera matrices) and optionally in TUM format.  With ground
truth, the Sim(3)-aligned ATE is printed.  The engine runs on the CUDA
card, and raises without one; ``--cpu`` asks for the CPU.

Usage:
  python examples/console_torch.py --dataset /path/to/euroc_or_tum_or_dir \\
      [--width 320 --height 180] [--csv fossil.csv] [--tum traj.tum] [--cpu]
      [--host-engine]
  python examples/console_torch.py --synthetic 80   # no dataset needed

``run(parse_args([...]))`` drives the same code from Python and returns
what it measured.  Each ``process_frame`` and the ``fossilize`` call run
inside a scope of ``utils/tracing.PROFILER`` (off unless enabled).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def fast_settings():
    """The settings of the JAX package's console (``fast_settings`` of
    ``tests/test_slam_e2e.py``): a modest feature budget, keyframes allowed
    often, small capacities."""
    from mageslam_tpu_torch import MageSlamSettings
    s = MageSlamSettings()
    s = s.replace(
        keyframe=s.keyframe.__class__(min_frame_count=3,
                                      min_frame_count_reloc=3,
                                      min_tracking_point_count=15),
        track_local_map=s.track_local_map.__class__(
            min_tracked_feature_count=10),
        capacity=s.capacity.__class__(
            max_features=320, max_keyframes=32, max_map_points=2048,
            local_ba_keyframes=8, local_ba_points=512,
            pose_history_size=512),
    )
    mono = s.mono
    fe = mono.camera.features.__class__(num_features=320, fast_threshold=10)
    cam = mono.camera.__class__(features=fe)
    init = mono.map_init.__class__(
        min_feature_matches=40, min_scoring_inliers=20,
        min_initial_map_points=15, min_map_points=20,
        max_parallax_3d_median_distance=60.0,
        min_initialization_interval_ms=100,
        max_initialization_interval_ms=600)
    return s.replace(mono=mono.__class__(camera=cam, map_init=init))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", type=str, default="")
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=180)
    ap.add_argument("--fx", type=float, default=0.0,
                    help="focal length in px at the tracking resolution "
                         "(default 0.85*width)")
    ap.add_argument("--csv", type=str, default="fossil.csv")
    ap.add_argument("--tum", type=str, default="")
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run the engine on the CPU instead of the card")
    ap.add_argument("--host-engine", action="store_true",
                    help="use the host-orchestrated engine (MageSlamTorch) "
                         "instead of the fused device engine")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, determinator=None) -> dict:
    """Drive one session; returns the engine, results, fossil, frame
    count, tracked count, the ATE (or None), the host clock after each
    frame and the frame source ("native", "python" or "synthetic").
    ``determinator`` (``utils/determinism.py``) receives the engine's
    checkpoint streams."""
    import numpy as np
    from mageslam_tpu_torch.geometry.camera import CameraCalibration
    from mageslam_tpu_torch.io.evaluation import ate_rmse
    from mageslam_tpu_torch.runtime.fused import MageSlamTorchFused
    from mageslam_tpu_torch.runtime.results import TrackingState
    from mageslam_tpu_torch.runtime.slam import MageSlamTorch
    from mageslam_tpu_torch.utils.tracing import scope_timer

    seq = None
    if args.dataset:
        from mageslam_tpu_torch.io.datasets import load_dataset
        seq = load_dataset(args.dataset, max_frames=args.max_frames)
        cal = seq.tracking_calibration(args.width)
        args.height = cal.height
        if args.fx:
            cal = CameraCalibration.pinhole(
                args.fx, args.fx, args.width / 2, args.height / 2,
                args.width, args.height)
    else:
        fx = args.fx or 0.85 * args.width
        cal = CameraCalibration.pinhole(fx, fx, args.width / 2,
                                        args.height / 2, args.width,
                                        args.height)
    engine = (MageSlamTorch if args.host_engine else MageSlamTorchFused)(
        fast_settings(), cal, seed=1, device="cpu" if args.cpu else None,
        determinator=determinator)

    if seq is not None:
        from mageslam_tpu_torch.io.native_loader import FramePump
        frames = FramePump(seq.image_paths, args.width, args.height,
                           capacity=8, n_threads=3)
        source = frames.backend
        print(f"[console] {len(seq.image_paths)} frames from "
              f"{args.dataset} ({seq.name}); gt="
              f"{seq.gt_view_poses is not None}; frame pump: {source}")
    else:
        from mageslam_tpu_torch.io.synthetic import (SyntheticWorld,
                                                     orbit_trajectory)
        n = args.synthetic or 80
        world = SyntheticWorld.create(700, seed=3)
        poses = orbit_trajectory(n, radius=2.0, forward=0.02, sweep=0.9)
        source = "synthetic"
        print(f"[console] {n} synthetic frames")
        frames = ((i, world.render(cal, p, seed=500 + i))
                  for i, p in enumerate(poses))

    t0 = time.perf_counter()
    stamps, count = [], 0
    for i, img in frames:
        ts = (float(seq.timestamps[i] - seq.timestamps[0])
              if seq is not None else i / args.fps)
        with scope_timer("console/process_frame"):
            engine.process_frame(img, timestamp=ts)
        stamps.append(time.perf_counter())
        count += 1
    # the host engine resolves every frame as it goes; the fused facade's
    # results resolve at its flush
    results = (engine.flush() if hasattr(engine, "flush")
               else engine._results)
    elapsed = time.perf_counter() - t0
    tracked = sum(r.state == TrackingState.TRACKING
                  for r in results.values())
    print(f"[console] tracked {tracked}/{count} frames "
          f"({count / elapsed:.1f} frames/s), "
          f"keyframes={engine.num_keyframes}, "
          f"map points={engine.num_map_points}")

    with scope_timer("console/fossilize"):
        fossil = engine.fossilize()
    fossil.export_csv(args.csv)
    print(f"[console] fossil CSV -> {args.csv} "
          f"({len(fossil.frame_ids)} poses)")
    if args.tum:
        fossil.export_tum(args.tum)
        print(f"[console] TUM -> {args.tum}")

    ate = None
    if seq is not None and seq.gt_view_poses is not None:
        gt = seq.gt_for_frames()
        fid_to_row = {int(f): k for k, f in enumerate(fossil.frame_ids)}
        rows = [(fid_to_row[i], i) for i in range(count) if i in fid_to_row]
        if len(rows) >= 3:
            ate, _, _ = ate_rmse(np.stack([fossil.poses[k] for k, _ in rows]),
                                 np.stack([gt[i] for _, i in rows]))
            print(f"[console] ATE RMSE (Sim3-aligned, {len(rows)} "
                  f"frames): {ate:.4f} m")
    return dict(engine=engine, results=results, fossil=fossil, count=count,
                tracked=tracked, ate=ate, stamps=stamps, source=source,
                sequence=seq)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
