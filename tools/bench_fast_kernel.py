#!/usr/bin/env python3
"""Time the FAST kernel of another commit beside the working tree's, on one
NVIDIA GPU in one process.

    git archive <commit> mageslam_tpu_torch/csrc | tar -x -C _chipcheck/old
    python3 tools/bench_fast_kernel.py \\
        old=_chipcheck/old/mageslam_tpu_torch/csrc/fast_detect.cu

Each ``label=source`` names a CUDA source with the C interface of
``mageslam_tpu_torch/csrc/fast_detect.cu``; the working tree's source is
always built too, as ``tree``.  Every build goes behind the package's own
wrappers (``fast_cuda.use_library``), is held against the plain PyTorch
version by ``chip_smoke.check_against_plain`` (score bit-exact, blur within
2e-3) and timed by ``chip_smoke.device_time_us`` (a CUDA graph of 200
launches replayed between two events, inputs L2-warm) on ``chip_smoke``'s
cases: a fixture frame and uniform noise at 180x320 and (the frame tiled
up) at 480x752.  The builds take turns, first to last and back, and the
better turn is printed beside the empty kernel's time on the tree's grid
and the roofline bound; the whole table follows as one JSON line.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main(argv) -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bench_fast_kernel: no CUDA device", file=sys.stderr)
        return 2
    from mageslam_tpu_torch.ops import fast, fast_cuda

    sources = {"tree": fast_cuda.SOURCE}
    for arg in argv:
        label, _, source = arg.partition("=")
        sources[label] = Path(source)
    libs = {label: fast_cuda.load(source)
            for label, source in sources.items()}
    smi = cs.run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"])
    entries = {
        "fast_detect_and_smooth":
            lambda im: fast_cuda.detect_and_smooth(im, cs.THRESHOLD, 7),
        "fast_detect": lambda im: fast_cuda.detect(im, cs.THRESHOLD)}

    table = {"gpu": smi, "builds": {k: str(v) for k, v in sources.items()},
             "cases": {}}
    for case, arr in cs.smoke_images(np, np.load(cs.FIXTURE)["imgs"]).items():
        img = torch.as_tensor(arr).cuda()
        fast_cuda.use_library(libs["tree"])
        row = {"floor_us": cs.device_time_us(
                   torch, lambda: fast_cuda.launch_floor(img)),
               "bound": {name: cs.roofline_bound(fast, img, cs.THRESHOLD,
                                                 name != "fast_detect")
                         for name in entries}}
        for label in list(libs) + list(libs)[::-1]:
            fast_cuda.use_library(libs[label])
            cs.check_against_plain(torch, fast, fast_cuda, img, 7,
                                   f"{case} {label}")
            for name, kernel in entries.items():
                row.setdefault(label, {}).setdefault(name, []).append(
                    cs.device_time_us(torch, lambda: kernel(img)))
        table["cases"][case] = row
        for label in libs:
            print(f"[{case}] {label}: " + ", ".join(
                f"{name} {min(v):.3f} us (turns {v[0]:.3f} / {v[1]:.3f}; "
                f"bound {row['bound'][name]['bound_us']:.3f} us by "
                f"{row['bound'][name]['bound_by']})"
                for name, v in row[label].items())
                + f"; empty kernel {row['floor_us']:.3f} us", flush=True)
    print(f"[table] {json.dumps(table)}")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
