#!/usr/bin/env python3
"""Where the fused engine's steady frame time goes, on one NVIDIA GPU.

    python3 tools/profile_torch_engine.py [--phase loop|device|feed]

The counterpart of ``tools/profile_engine.py`` for ``mageslam_tpu_torch``,
at ``bench_torch.py``'s shapes (``ref_settings()``: 440 features, the
default capacities) on its device-step orbit (60 frames, ``forward=0.008``):

- ``loop``: 40 frames to reach a tracking state, then frames 40-59 three
  times through ``process_frame`` and ``flush`` (the bench's own loop): ms
  per frame, frames/s and host syncs per frame;
- ``device``: ``bench_torch.py --device-step``'s record (50 chained
  ``DeviceEngine.step`` calls from a cloned state, one sync at the end;
  the median dispatch of one call; host syncs, kernels and kernel ms per
  step from ``torch.profiler``);
- ``feed``: the per-frame host-to-device feed as the facade does it (a
  pinned copy queued on the stream) and ``to_gray_f32``, 50 frames each,
  timed between two device syncs.

Each phase runs in a process of its own (timing in the process of an
earlier drive measures that drive's leftovers); with no ``--phase`` the
script runs itself once per phase.  There is no CPU path: without a CUDA
device it exits with code 2.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PHASES = ("loop", "device", "feed")
FEED_FRAMES = 50
LOOP_REPS = 3


def feed_phase(imgs) -> None:
    import torch
    from mageslam_tpu_torch.ops import pyramid
    dev = torch.device("cuda")

    def upload(img):
        return torch.as_tensor(img).pin_memory().to(dev, non_blocking=True)

    upload(imgs[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(FEED_FRAMES):
        g = upload(imgs[i % 40])
    torch.cuda.synchronize()
    print(f"frame feed (pinned copy) per frame: "
          f"{(time.perf_counter() - t0) / FEED_FRAMES * 1e3:.3f} ms",
          flush=True)
    on_card = [upload(im) for im in imgs[:40]]
    pyramid.to_gray_f32(on_card[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(FEED_FRAMES):
        g = pyramid.to_gray_f32(on_card[i % 40])
    torch.cuda.synchronize()
    print(f"to_gray_f32 per frame: "
          f"{(time.perf_counter() - t0) / FEED_FRAMES * 1e3:.3f} ms "
          f"({tuple(g.shape)})", flush=True)


def loop_phase(imgs) -> None:
    import torch
    from bench_torch import STEP_DRIVE, make_engine, ref_settings
    eng = make_engine(ref_settings())
    for i, img in enumerate(imgs[:STEP_DRIVE]):
        eng.process_frame(img, timestamp=i / 30.0)
    eng.flush()
    rest = imgs[STEP_DRIVE:]
    syncs = eng.host_syncs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(LOOP_REPS):
        for i, img in enumerate(rest):
            eng.process_frame(
                img, timestamp=(STEP_DRIVE + r * len(rest) + i) / 30.0)
    eng.flush()
    n = LOOP_REPS * len(rest)
    loop_ms = (time.perf_counter() - t0) / n * 1e3
    print(f"full loop per frame: {loop_ms:.2f} ms ({1e3 / loop_ms:.2f} "
          f"frames/s), host syncs per frame "
          f"{(eng.host_syncs - syncs) / n:.2f}, initialized "
          f"{bool(eng.state.initialized)}", flush=True)


def device_phase() -> None:
    from bench_torch import device_step_run
    rec = device_step_run()
    print(f"device step (chained, one sync): {rec['device_step_ms']:.2f} ms",
          flush=True)
    print(f"dispatch per step: median {rec['dispatch_ms_median']:.2f} ms; "
          f"host syncs per step {rec['host_syncs_per_step']:.2f}; "
          f"{rec['kernels_per_step']:.1f} kernels, "
          f"{rec['kernel_ms_per_step']:.2f} ms of kernel time per step "
          f"(device busy {100 * rec['device_busy']:.1f}% of the chained "
          f"step); re-stepped clones equal: {rec['restep_equal']}; "
          f"initialized {rec['initialized']}", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_engine: no CUDA device", file=sys.stderr)
        return 2
    if "--phase" not in argv:
        from mageslam_tpu_torch.ops import fast_cuda
        fast_cuda.build()     # one build, before the phases load it
        rc = 0
        for ph in PHASES:
            rc |= subprocess.run([sys.executable, __file__, "--phase", ph],
                                 timeout=900).returncode
        return rc
    phase = argv[argv.index("--phase") + 1]
    if phase not in PHASES:
        print(f"profile_torch_engine: unknown phase {phase!r}",
              file=sys.stderr)
        return 2
    from bench_torch import device_step_frames, gpu_line
    print(f"{gpu_line()}; phase={phase}", flush=True)
    if phase == "device":
        device_phase()
        return 0
    imgs = device_step_frames()
    if phase == "feed":
        feed_phase(imgs)
    else:
        loop_phase(imgs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
