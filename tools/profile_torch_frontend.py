#!/usr/bin/env python3
"""Per-stage timing of the frontend and the tracking step on one NVIDIA GPU.

    python3 tools/profile_torch_frontend.py

The counterpart of ``tools/profile_frontend.py`` for ``mageslam_tpu_torch``,
with its arguments (FAST threshold 20, 320 features, 32x32 cells, 4 per
cell) on a 180x320 render of the 700-point synthetic world: each stage of
``extract_features`` on its own (the fused FAST kernel, and for comparison
the plain blur and the score-only kernel; gridded selection; subpixel
refinement; orientation and BRIEF), the whole ``extract_features``, and
``track.track_frame`` on a real map (the JAX engine's state after frame 40
of ``tests/data/torch_orbit60.npz``, at its ``fast_settings()``
capacities, tracking frame 41 from the constant-velocity prior).  Each
stage: 3 warm-up calls, then 20 calls between two CUDA events, in ms per
call (device time, host launch gaps included).

There is no CPU path: without a CUDA device the script exits with code 2.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "examples"))

ORBIT60 = ROOT / "tests" / "data" / "torch_orbit60.npz"
CALLS, WARMUP = 20, 3
THRESHOLD, FEATURES = 20.0, 320


def stages(dev) -> dict:
    """{stage: zero-argument call} on inputs already on ``dev``."""
    import torch
    from console_torch import fast_settings
    from mageslam_tpu_torch import convert
    from mageslam_tpu_torch.geometry import se3
    from mageslam_tpu_torch.geometry.camera import CameraCalibration
    from mageslam_tpu_torch.io.synthetic import (SyntheticWorld,
                                                 default_calibration)
    from mageslam_tpu_torch.ops import fast, fast_cuda, orb, pyramid, select
    from mageslam_tpu_torch.tracking import track
    from mageslam_tpu_torch.tracking.frontend import extract_features

    cal = default_calibration()
    world = SyntheticWorld.create(700, seed=3)
    img = torch.as_tensor(world.render(cal, np.asarray(
        [0, 0, 0, 1, 0, 0, 0], np.float32), seed=7), device=dev)
    cal = cal.to(dev)
    score, smooth = fast_cuda.detect_and_smooth(img, THRESHOLD, 7)
    kps = select.select_gridded(score, FEATURES, 32, 32, 4)

    z = np.load(ORBIT60)
    fx, fy, cx, cy, w, h = z["cal"].tolist()
    zcal = CameraCalibration.pinhole(fx, fy, cx, cy, int(w), int(h)).to(dev)
    st = convert.engine_state_from_npz(z, "fast_state40/", device=dev)
    s = fast_settings()
    frame = torch.as_tensor(z["imgs"][41], device=dev).to(torch.float32)
    feats = extract_features(frame, zcal, 10.0, max_features=FEATURES)
    prior = se3.constant_velocity_extrapolate(st.pose_prev2, st.pose_prev)
    return {
        "fast_detect_and_smooth (kernel)": lambda: fast_cuda.detect_and_smooth(
            img, THRESHOLD, 7),
        "gaussian_blur (plain)": lambda: pyramid.gaussian_blur(img, 7),
        "fast_detect (kernel)": lambda: fast_cuda.detect(img, THRESHOLD),
        "select_gridded": lambda: select.select_gridded(score, FEATURES, 32,
                                                        32, 4),
        "subpixel": lambda: fast.subpixel_offsets(
            fast.score_patches_at(img, kps.uv, THRESHOLD)),
        "orient_and_describe": lambda: orb.orient_and_describe(
            smooth, kps.uv, False, bilinear=True),
        "extract_features": lambda: extract_features(
            img, cal, THRESHOLD, max_features=FEATURES, num_levels=1),
        "track_frame": lambda: track.track_frame(
            st.map, feats, prior, st.last_kf, zcal, s,
            max_local_kf=s.capacity.local_ba_keyframes),
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_frontend: no CUDA device", file=sys.stderr)
        return 2
    from bench_torch import gpu_line, time_calls
    print(f"image (180, 320) on {gpu_line()}")
    for name, fn in stages(torch.device("cuda")).items():
        _, ms = time_calls(fn, CALLS, cuda=True, warmup=WARMUP)
        print(f"{name:34s} {ms:8.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
