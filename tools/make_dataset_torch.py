"""Render a real-photo-textured sequence to an EuRoC-format directory, with
the PyTorch port's copies of the synthetic and real-texture worlds.

The counterpart of ``tools/make_dataset.py``; the same arguments give the
same frames.  It writes the layout ``io/datasets.load_euroc`` reads:

    <out>/mav0/cam0/data/<ns>.png      grayscale frames
    <out>/mav0/cam0/data.csv           "#timestamp [ns],filename"
    <out>/mav0/cam0/sensor.yaml        intrinsics
    <out>/mav0/state_groundtruth_estimate0/data.csv
                                       "#ts, px,py,pz, qw,qx,qy,qz" (world)

It runs on the CPU (numpy renders, torch CPU tensors for the poses) and
needs matplotlib and PIL (``io/real_texture.py``).

Usage:
    python tools/make_dataset_torch.py --out /tmp/seq --frames 40 \\
        [--scenario orbit|ring]
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def scenario(name: str, frames: int):
    """(world, view poses (frames, 7)) of a scenario: ``orbit`` (the cloud
    world, seed 3) or ``ring`` (the ring world, seed 5, loop trajectory)."""
    from mageslam_tpu_torch.io.real_texture import (create_real_cloud,
                                                    create_real_ring)
    from mageslam_tpu_torch.io.synthetic import (loop_trajectory,
                                                 orbit_trajectory)
    if name == "orbit":
        return create_real_cloud(700, seed=3), orbit_trajectory(
            frames, radius=2.0, forward=0.02, sweep=0.9)
    if name == "ring":
        return create_real_ring(900, seed=5), loop_trajectory(frames,
                                                              radius=3.0)
    raise ValueError(f"unknown scenario {name!r}")


def write_euroc(out: str, world, poses) -> int:
    """Render ``poses`` (frame i with seed 900 + i) into ``out``; returns
    the bytes of PNG written."""
    import torch
    from PIL import Image

    from mageslam_tpu_torch.geometry import se3
    from mageslam_tpu_torch.io.synthetic import default_calibration

    cal = default_calibration()
    cam_dir = os.path.join(out, "mav0", "cam0")
    data_dir = os.path.join(cam_dir, "data")
    gt_dir = os.path.join(out, "mav0", "state_groundtruth_estimate0")
    os.makedirs(data_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)

    rows, gt_rows = [], []
    for i, p in enumerate(poses):
        img = world.render(cal, p, seed=900 + i)
        ns = int((i / 30.0) * 1e9)
        name = f"{ns}.png"
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            os.path.join(data_dir, name))
        rows.append(f"{ns},{name}")
        # ground truth is world-from-camera (EuRoC's p_WB, q_WB): the
        # inverse view pose's rotation and the camera centre
        pose = torch.as_tensor(np.asarray(p, np.float32))
        q = se3.pose_inverse(pose).numpy()[:4]
        c = se3.camera_center(pose).numpy()
        gt_rows.append(f"{ns},{c[0]},{c[1]},{c[2]},"
                       f"{q[0]},{q[1]},{q[2]},{q[3]}")

    with open(os.path.join(cam_dir, "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        f.write("\n".join(rows) + "\n")
    with open(os.path.join(cam_dir, "sensor.yaml"), "w") as f:
        f.write("sensor_type: camera\n"
                "intrinsics: [%f, %f, %f, %f]\n"
                "resolution: [%d, %d]\n"
                "distortion_model: radial-tangential\n"
                "distortion_coefficients: [0.0, 0.0, 0.0, 0.0]\n"
                % (cal.fx, cal.fy, cal.cx, cal.cy, cal.width, cal.height))
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
                "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z []\n")
        f.write("\n".join(gt_rows) + "\n")
    return sum(os.path.getsize(os.path.join(data_dir, f))
               for f in os.listdir(data_dir))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--scenario", default="orbit", choices=["orbit", "ring"])
    args = ap.parse_args(argv)
    world, poses = scenario(args.scenario, args.frames)
    total = write_euroc(args.out, world, poses)
    print(f"wrote {len(poses)} frames to {args.out} "
          f"({total / 1024:.0f} KiB of PNGs)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
