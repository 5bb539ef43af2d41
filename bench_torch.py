#!/usr/bin/env python3
"""Benchmark of the PyTorch port: tracked frames/s on one NVIDIA GPU.

    python3 bench_torch.py                  # the drive: one JSON line
    python3 bench_torch.py --kernel-table   # KERNEL_TABLE line (stdout)
    python3 bench_torch.py --device-step    # DEVICE_STEP line (stdout)
    MAGESLAM_BENCH_FAST=1 python3 bench_torch.py   # fast_settings()

The counterpart of ``bench.py`` for ``mageslam_tpu_torch``, with its
fixture, its settings and its contract: stdout carries exactly one JSON
line, ``{"metric": "tracked_frames_per_s_per_chip", "value", "unit":
"frames/s", "vs_baseline"}``, where ``vs_baseline`` is against the
reference's real-time target of 30 frames/s (``MAGESlam.cpp:37``).

The drive: ``MageSlamTorchFused(settings, cal, seed=1)`` over
``bench.py``'s 250 frames (``SyntheticWorld.create(700, seed=3)``,
``orbit_trajectory(250, radius=2.0, forward=0.0032, sweep=0.9)``, render
seed 500 + i, cached in ``.bench_torch_frames.npz``).  Each of 5 drives
calls ``reset(seed=1)``, runs the 50 warm-up frames through
``process_sequence`` and ``flush``, then times the other 200 the same way;
the median drive gives frames/s and the tracked count.

Then two fresh processes, as ``bench.py`` runs them (timing in the
process of a drive measures the drive's leftovers): the kernel table
(local BA at 24 cameras / 2048 points / 8 LM steps, and the frontend at
the bench's single level and at 2 levels; one warm call, then 20 calls
between two device syncs, on the host clock and by CUDA events), and the
device step (40 frames of the 60-frame orbit with ``forward=0.008``, then
50 chained ``DeviceEngine.step`` calls from a clone of the state with one
sync at the end, and 50 more timed one by one).  The port's step reads
device scalars on the host (``host_syncs``), so a chain is not free of
readbacks: the record gives the host syncs per step, and ``torch.profiler``
gives kernels and kernel time per step beside it.  stderr ends with
``KERNEL_TABLE {...}``: ``bench.py``'s keys, the host syncs per frame and
per step, and the card's ``nvidia-smi`` name and power limit.

The bench runs on the card and has no CPU path: without a CUDA device it
exits with code 2.  Its functions take ``device=`` for the tests.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

FRAME_CACHE_VERSION = 4   # bench.py's: bump when the renderer changes
FRAME_CACHE = ROOT / ".bench_torch_frames.npz"
N_FRAMES, WARMUP, N_DRIVES = 250, 50, 5
TABLE_CALLS = 20
STEP_DRIVE, STEP_FRAMES, STEP_CHAIN, PROFILED_STEPS = 40, 60, 50, 10
INIT_SEEDS, INIT_FRAMES = tuple(range(1, 13)), 20
METRIC = "tracked_frames_per_s_per_chip"
TARGET_FPS = 30.0


def ref_settings():
    """``bench.py``'s reference-shaped configuration in the port's settings
    classes: the defaults (loop closure and cheap loop closure on), the
    golden path's 440 features (MageSettings.h:152) and the e2e fixture's
    keyframe cadence."""
    from mageslam_tpu_torch import MageSlamSettings
    s = MageSlamSettings()
    mono = s.mono
    fe = mono.camera.features.__class__(num_features=440,
                                        fast_threshold=10)
    cam = mono.camera.__class__(features=fe)
    return s.replace(mono=mono.__class__(camera=cam,
                                         map_init=mono.map_init),
                     keyframe=s.keyframe.__class__(
                         min_frame_count=3, min_frame_count_reloc=3,
                         min_tracking_point_count=15))


def bench_settings():
    """``ref_settings()``, or with ``MAGESLAM_BENCH_FAST`` set the console's
    ``fast_settings()`` (test-sized capacities)."""
    if os.environ.get("MAGESLAM_BENCH_FAST"):
        sys.path.insert(0, str(ROOT / "examples"))
        from console_torch import fast_settings
        return fast_settings()
    return ref_settings()


def render_bench_frames(indices=None):
    """``bench.py``'s frames (float32 (180, 320)) at ``indices`` (all 250
    by default), rendered by the port's copy of the synthetic world."""
    from mageslam_tpu_torch.io.synthetic import (SyntheticWorld,
                                                 default_calibration,
                                                 orbit_trajectory)
    cal = default_calibration()
    world = SyntheticWorld.create(700, seed=3)
    # forward scaled so that 250 frames cover the space of bench.py's
    # earlier 100-frame fixture (0.008 * 100 = 0.0032 * 250)
    poses = orbit_trajectory(N_FRAMES, radius=2.0, forward=0.0032,
                             sweep=0.9)
    indices = range(N_FRAMES) if indices is None else indices
    return [world.render(cal, poses[i], seed=500 + i) for i in indices]


def bench_frames(cache: Path = FRAME_CACHE):
    """All 250 frames, from the cache when it holds this renderer's."""
    import numpy as np
    if cache.exists():
        with np.load(cache) as z:
            if int(z["version"]) == FRAME_CACHE_VERSION:
                return list(z["imgs"])
    imgs = render_bench_frames()
    np.savez_compressed(cache, imgs=np.stack(imgs),
                        version=FRAME_CACHE_VERSION)
    return imgs


def frame_crcs(imgs):
    """CRC-32 of each frame's bytes (``tests/data/torch_bench.npz`` holds
    those of the JAX package's renderer)."""
    import numpy as np
    return np.array([zlib.crc32(np.ascontiguousarray(im).tobytes())
                     for im in imgs], np.int64)


def make_engine(settings=None, device=None):
    from mageslam_tpu_torch.io.synthetic import default_calibration
    from mageslam_tpu_torch.runtime.fused import MageSlamTorchFused
    return MageSlamTorchFused(settings or bench_settings(),
                              default_calibration(), seed=1, device=device)


def bench_drive(engine, imgs, warmup: int = WARMUP) -> dict:
    """One drive of ``bench.py``'s loop on a reset engine: frames/s and
    tracked count over the frames after ``warmup``, the host syncs per
    timed frame and every frame's state code."""
    import numpy as np
    from mageslam_tpu_torch.runtime.results import state_codes
    n = len(imgs)
    ts = [i / 30.0 for i in range(n)]
    engine.reset(seed=1)
    engine.process_sequence(imgs[:warmup], ts[:warmup])
    engine.flush()
    syncs = engine.host_syncs
    t0 = time.perf_counter()
    engine.process_sequence(imgs[warmup:], ts[warmup:])
    results = engine.flush()     # waits for the last step's output row
    seconds = time.perf_counter() - t0
    codes = state_codes(results[i].state for i in range(n))
    tracking = np.nonzero(codes == 2)[0]
    return {"fps": (n - warmup) / seconds,
            "tracked": int((codes[warmup:] == 2).sum()),
            "first_tracking": int(tracking[0]) if len(tracking) else -1,
            "host_syncs_per_frame": (engine.host_syncs - syncs)
            / (n - warmup),
            "codes": codes}


def first_tracking_frames(engine, imgs, seeds=INIT_SEEDS):
    """For each of ``seeds``, the first tracking frame of a drive over
    ``imgs`` from ``reset(seed)`` (-1: none).  The frame at which the
    monocular map initializes is set by the initialization RANSAC's draws,
    and so by the seed and the generator: ``jax.random``, torch's CPU
    generator and its CUDA one draw differently from one seed.  The spread
    over seeds is what a port shares with its reference; one seed's frame
    is one draw of it."""
    import numpy as np
    from mageslam_tpu_torch.runtime.results import state_codes
    ts = [i / 30.0 for i in range(len(imgs))]
    firsts = []
    for seed in seeds:
        engine.reset(seed=seed)
        engine.process_sequence(imgs, ts)
        results = engine.flush()
        codes = state_codes(results[i].state for i in range(len(imgs)))
        tracking = np.nonzero(codes == 2)[0]
        firsts.append(int(tracking[0]) if len(tracking) else -1)
    return np.array(firsts, np.int64)


def run_drives(engine, imgs, n_drives: int = N_DRIVES):
    """``n_drives`` drives, sorted by frames/s; the median one is
    ``drives[len(drives) // 2]``."""
    return sorted((bench_drive(engine, imgs) for _ in range(n_drives)),
                  key=lambda d: d["fps"])


def metric_line(fps: float) -> dict:
    return {"metric": METRIC, "value": round(fps, 2), "unit": "frames/s",
            "vs_baseline": round(fps / TARGET_FPS, 3)}


# ----------------------------------------------------------------------
def kernel_table_problem(settings, device=None):
    """``bench.py``'s local-BA problem, drawn in its order from
    ``default_rng(0)``: 24 cameras (9 fixed) at the identity, the
    settings' ``local_ba_points`` landmarks, 24 observation slots of which
    12% are valid, one empty tether."""
    import numpy as np
    import torch
    from mageslam_tpu_torch.geometry import se3
    from mageslam_tpu_torch.solvers.bundle_adjust import (BAProblem,
                                                          empty_tethers)
    rng = np.random.default_rng(0)
    K, L, M = 24, settings.capacity.local_ba_points, 24
    pts = rng.uniform(-2, 2, (L, 3)).astype(np.float32) + [0, 0, 6]
    obs_xn = rng.normal(0, 0.1, (L, M, 2))
    obs_valid = rng.random((L, M)) < 0.12

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return BAProblem(
        kf_poses=se3.pose_identity(device).expand(K, 7).clone(),
        kf_fixed=torch.arange(K, device=device) < 9,
        points=dev(pts, torch.float32),
        point_valid=torch.ones(L, dtype=torch.bool, device=device),
        obs_kf=torch.arange(M, dtype=torch.int32, device=device)[None]
        .expand(L, M).contiguous(),
        obs_xn=dev(obs_xn, torch.float32),
        obs_valid=dev(obs_valid, torch.bool),
        **empty_tethers(1, device))


def kernel_table_calls(settings, device=None) -> dict:
    """The table's rows as {name: zero-argument call}, on inputs already
    on ``device``."""
    import numpy as np
    import torch
    from mageslam_tpu_torch.io.synthetic import (SyntheticWorld,
                                                 default_calibration,
                                                 orbit_trajectory)
    from mageslam_tpu_torch.solvers.bundle_adjust import bundle_adjust_impl
    from mageslam_tpu_torch.tracking.frontend import (extract_features,
                                                      extract_for_settings)
    problem = kernel_table_problem(settings, device)
    huber, outlier = float(np.float32(0.007)), float(np.float32(0.027))
    cal = default_calibration().to(device)
    world = SyntheticWorld.create(700, seed=3)
    img = torch.as_tensor(world.render(
        default_calibration(), orbit_trajectory(2, radius=2.0)[0], seed=1),
        device=device)
    F = settings.capacity.max_features
    return {
        "local_BA(24cam/2048pts/8LM)": lambda: bundle_adjust_impl(
            problem, huber, outlier, num_steps=8),
        "extract_features(440/512slots)": lambda: extract_for_settings(
            img, cal, settings.mono.camera, F),
        # the same budget over a 2-level pyramid (the golden path runs 1)
        "extract_features(2level)": lambda: extract_features(
            img, cal, 10.0, max_features=F, num_levels=2, scale_factor=1.5),
    }


def time_calls(fn, calls: int, cuda: bool, warmup: int = 1):
    """(host ms, event ms) per call of ``fn``: ``warmup`` calls, then
    ``calls`` calls between two device syncs on the host clock and two CUDA
    events (event ms None off the card)."""
    import torch
    for _ in range(warmup):
        fn()
    if cuda:
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    if cuda:
        b.record()
        torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / calls * 1e3
    return host, (a.elapsed_time(b) / calls if cuda else None)


def kernel_table(settings, calls: int = TABLE_CALLS) -> dict:
    """Per row: ms per call on the host clock (``bench.py``'s number: a
    warm call, then ``calls`` calls between two device syncs) and by CUDA
    events around the same calls."""
    rows, event_ms = {}, {}
    for name, fn in kernel_table_calls(settings, "cuda").items():
        rows[name], event_ms[name] = time_calls(fn, calls, cuda=True)
    return {**{k: round(v, 3) for k, v in rows.items()},
            "event_ms": {k: round(v, 3) for k, v in event_ms.items()}}


# ----------------------------------------------------------------------
def clone_state(x):
    """A copy of every tensor of a (nested) NamedTuple state: ``step``
    writes into some of its state's tensors."""
    import torch
    if torch.is_tensor(x):
        return x.clone()
    if hasattr(x, "_fields"):
        return type(x)(*(clone_state(v) for v in x))
    return x


def _leaves(x):
    if hasattr(x, "_fields"):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def states_equal(a, b) -> bool:
    import torch
    return all(torch.equal(u, v) for u, v in zip(_leaves(a), _leaves(b)))


def device_step_frames():
    """The 60-frame orbit of ``bench.py --device-step`` (and of
    ``tests/data/torch_orbit60.npz``, which stores it truncated to uint8),
    as float32 renders."""
    from mageslam_tpu_torch.io.synthetic import (SyntheticWorld,
                                                 default_calibration,
                                                 orbit_trajectory)
    cal = default_calibration()
    world = SyntheticWorld.create(700, seed=3)
    poses = orbit_trajectory(STEP_FRAMES, radius=2.0, forward=0.008,
                             sweep=0.9)
    return [world.render(cal, p, seed=500 + i) for i, p in enumerate(poses)]


def _profile_steps(engine, st, img, n: int):
    """Kernels and kernel ms per step over ``n`` chained steps, from
    ``torch.profiler`` (its kernel rows only: an operator's row repeats
    its kernels' time), and the profiled window's host ms per step (the
    profiler's own cost included)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            st, out = engine.step(st, img, 1.0, STEP_DRIVE + 1)
        torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_ms = 1e-3 * sum(device_us(e) for e in dev)
    return {"kernels_per_step": sum(e.count for e in dev) / n,
            "kernel_ms_per_step": kernel_ms / n,
            "profiled_step_ms": window_ms / n}


def device_step(engine, st, img, chain: int = STEP_CHAIN,
                profiled: int = PROFILED_STEPS) -> dict:
    """``bench.py --device-step`` on a port ``DeviceEngine`` at state
    ``st`` with frame ``img`` (on the engine's device).

    Every run starts from a clone of ``st`` and of the engine's generator
    state.  Two single steps from such clones must give equal output rows
    and states (``restep_equal``): the chain then measures a fresh state,
    not one that an earlier step wrote into.  ``chain`` steps, each fed
    the last one's state, are timed with one sync at the end
    (``device_step_ms``), then ``chain`` more one by one without a sync
    (the median is ``dispatch_ms_median``); the host syncs they made are
    counted.  On a card, ``profiled`` more chained steps run under
    ``torch.profiler``, and ``device_busy`` is their kernel time over the
    unprofiled ``device_step_ms``; elsewhere these keys are None (not
    measured)."""
    import numpy as np
    import torch
    cuda = engine.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    gen = engine.gen.get_state()
    fid = STEP_DRIVE + 1

    def fresh():
        engine.gen.set_state(gen)
        return clone_state(st)

    engine.step(fresh(), img, 1.0, fid)          # warm-up
    s1, o1 = engine.step(fresh(), img, 1.0, fid)
    s2, o2 = engine.step(fresh(), img, 1.0, fid)
    sync()
    restep_equal = torch.equal(o1, o2) and states_equal(s1, s2)

    s = fresh()
    syncs = engine.host_syncs
    sync()
    t0 = time.perf_counter()
    for _ in range(chain):
        s, out = engine.step(s, img, 1.0, fid)
    sync()
    step_ms = (time.perf_counter() - t0) / chain * 1e3
    syncs = engine.host_syncs - syncs

    s = fresh()
    sync()
    dispatch = []
    for _ in range(chain):
        t0 = time.perf_counter()
        s, out = engine.step(s, img, 1.0, fid)
        dispatch.append(time.perf_counter() - t0)
    sync()
    prof = dict.fromkeys(("kernels_per_step", "kernel_ms_per_step",
                          "profiled_step_ms", "device_busy"))
    if cuda and profiled:
        prof = _profile_steps(engine, fresh(), img, profiled)
        prof["device_busy"] = prof["kernel_ms_per_step"] / step_ms
    return {"device": torch.cuda.get_device_name(engine.device) if cuda
            else str(engine.device),
            "device_step_ms": round(step_ms, 3),
            "dispatch_ms_median": round(float(np.median(dispatch)) * 1e3, 3),
            "host_syncs_per_step": syncs / chain,
            "restep_equal": bool(restep_equal),
            "chain": chain, **prof}


def device_step_run(device=None, settings=None) -> dict:
    """Drive the first 40 frames of the device-step orbit, flush, and
    measure ``device_step`` from the state reached, on frame 40."""
    import torch
    imgs = device_step_frames()
    eng = make_engine(settings or ref_settings(), device)
    for i, img in enumerate(imgs[:STEP_DRIVE]):
        eng.process_frame(img, timestamp=i / 30.0)
    eng.flush()
    img = torch.as_tensor(imgs[STEP_DRIVE], device=eng.device)
    rec = device_step(eng.engine, eng.state, img)
    rec["initialized"] = bool(eng.state.initialized)
    return rec


# ----------------------------------------------------------------------
def gpu_line() -> str:
    """``nvidia-smi``'s name and power limit of the cards."""
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e.__class__.__name__})"
    return (proc.stdout or proc.stderr).strip()


def sub_record(flag: str, tag: str, timeout: float) -> dict:
    """Run this script with ``flag`` in a fresh process and return the
    JSON of its ``tag`` line; raise if it has none."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           flag], capture_output=True, text=True,
                          timeout=timeout, cwd=str(ROOT))
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith(tag + " ")), None)
    if line is None:
        raise RuntimeError(f"{flag}: no {tag} line, rc={proc.returncode}: "
                           f"{proc.stderr[-2000:]}")
    return json.loads(line[len(tag) + 1:])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    import torch
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device; the bench measures the card "
              "and has no CPU path", file=sys.stderr)
        return 2
    from mageslam_tpu_torch.ops import fast_cuda
    # one kernel build, before any child process loads it
    fast_cuda.build()
    if "--kernel-table" in argv:
        print("KERNEL_TABLE " + json.dumps(kernel_table(ref_settings())))
        return 0
    if "--device-step" in argv:
        print("DEVICE_STEP " + json.dumps(device_step_run()))
        return 0

    imgs = bench_frames()
    drives = run_drives(make_engine(), imgs)
    med = drives[len(drives) // 2]
    print(json.dumps(metric_line(med["fps"])))
    sys.stdout.flush()

    rows = sub_record("--kernel-table", "KERNEL_TABLE", 900)
    rows.update(sub_record("--device-step", "DEVICE_STEP", 900))
    rows.update({
        "steady_fps": round(med["fps"], 3),
        "drive_fps": [round(d["fps"], 1) for d in drives],
        "tracked_frames": med["tracked"],
        # a drive that never initializes times a step without mapping
        "initialized": med["first_tracking"] >= 0,
        "first_tracking_frame": med["first_tracking"],
        "host_syncs_per_frame": round(med["host_syncs_per_frame"], 3),
        "gpu": gpu_line(),
    })
    print("KERNEL_TABLE " + json.dumps(rows), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
