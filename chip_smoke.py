#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):

1. device check — a CUDA device must be present; there is no CPU path;
2. toolchain record (torch, CUDA, nvcc, triton, ninja, the card);
3. build of the hand-written FAST kernel (``mageslam_tpu_torch/csrc``);
4. both kernel entry points (``fast_detect_and_smooth``, ``fast_detect``)
   against their plain PyTorch versions on the card, at 180x320 (the main
   path's shape) and 480x752, each on a fixture frame (tiled up for the
   larger shape) and on uniform noise, plus an odd size, a checkerboard and
   3- and 5-tap blurs: NMS'd score bit-exact, blur within 2e-3.  Timings per
   case and entry point: one call by CUDA events (median of 60 after
   warm-up, in turns plain / kernel / kernel / plain: this is launch
   latency), the kernel's device time (a CUDA graph of 200 launches
   replayed between two events, divided by 200; inputs stay L2-warm, as the
   main path finds its freshly written grey frame), the device time of an
   empty kernel on the same grid, and the roofline bound computed from the
   image (bytes moved at 3.35 TB/s against the float32 operations these
   pixels need at 33.5e12 a second, none of them a multiply-add, whichever
   is larger);
5. the engine's golden path: ``MageSlamTorchFused`` (on the card by
   default) at the reference-shaped settings (440 features, 512 feature
   slots, 256 keyframes, 8192 map points, 16-keyframe / 2048-point local
   BA; loop closure off) over the 60-frame fixture
   ``tests/data/torch_orbit60.npz``, then ``fossilize``; checks that it
   initializes, tracks at least the JAX engine's count minus 3, yields
   finite poses, went through ``fast_detect_and_smooth`` once per frame,
   and keeps the Sim3-aligned ATE under the bound stored in the fixture;
6. the same engine with a 9-tap blur for 15 frames: the frontend then takes
   the plain blur and the ``fast_detect`` entry point, once per frame; it
   must initialize and end tracking, and the frontend's features on the
   card are held against the CPU's.

Launch counts are set to 0 just before each drive and read just after.
The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "data" / "torch_orbit60.npz"
BLUR_ATOL = 2e-3
TIMING_RUNS = 60
GRAPH_LAUNCHES = 200
THRESHOLD = 10.0
WIDE_BLUR_FRAMES = 15

# published peaks of one H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM
# and 67 TFLOP/s of float32, which counts each multiply-add as two.  The
# operations counted below are subtractions, minima, maxima, compares and
# unfused multiplies and adds, one instruction each, so the card issues at
# most half that many a second.
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12 / 2
# float32 operations the function needs: per interior pixel the antipodal
# test (16 differences, 16 pair min/max, 14 to reduce them, 2 compares);
# per candidate polarity the arc scan (64 min, 16 max, the threshold, the
# clamp); per pixel the 3x3 NMS (8 max, 2 compares) and the two 7-tap blur
# passes (7 multiplies + 6 adds each)
PAIR_TEST_OPS, ARC_SCAN_OPS, NMS_OPS, BLUR_OPS = 48, 82, 10, 26


def run_text(cmd) -> str:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e.__class__.__name__})"
    return (proc.stdout or proc.stderr).strip()


def ref_settings_loop_off(gaussian_kernel_size: int = 7):
    """bench.py's reference-shaped settings, loop closure off."""
    from mageslam_tpu_torch import MageSlamSettings
    s = MageSlamSettings()
    mono = s.mono
    fe = dataclasses.replace(mono.camera.features, num_features=440,
                             fast_threshold=int(THRESHOLD),
                             gaussian_kernel_size=gaussian_kernel_size)
    cam = dataclasses.replace(mono.camera, features=fe)
    s = s.replace(mono=dataclasses.replace(mono, camera=cam),
                  keyframe=dataclasses.replace(
                      s.keyframe, min_frame_count=3, min_frame_count_reloc=3,
                      min_tracking_point_count=15))
    return s.replace(
        loop_closure=dataclasses.replace(s.loop_closure,
                                         enable_loop_closure=False),
        mapping=dataclasses.replace(s.mapping, use_cheap_loop_closure=False))


def time_ms(torch, fn, runs: int = TIMING_RUNS) -> float:
    """Median milliseconds of one call, by CUDA events (launch latency
    included)."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_time_us(torch, fn, launches: int = GRAPH_LAUNCHES,
                   replays: int = 9) -> float:
    """Device microseconds of one launch of ``fn``: a CUDA graph of
    ``launches`` back-to-back calls, replayed between two events; the median
    replay divided by the count.  The graph takes the host out of the
    measurement; the same input every time keeps it in the L2 cache."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return 1e3 * times[len(times) // 2] / launches


def roofline_bound(fast, img, threshold: float, blur: bool) -> dict:
    """Least time the card could take for this image: bytes (the frame read
    once, each output written once) against the operations its pixels
    need, candidates counted from the data."""
    h, w = img.shape
    bright, dark = fast.antipodal_candidates(img, threshold)
    scans = int(bright.sum()) + int(dark.sum())
    interior = max(h - 6, 0) * max(w - 6, 0)
    ops = (interior * PAIR_TEST_OPS + scans * ARC_SCAN_OPS
           + h * w * (NMS_OPS + (BLUR_OPS if blur else 0)))
    nbytes = h * w * 4 * (3 if blur else 2)
    by_bytes = 1e6 * nbytes / H100_BYTES_PER_S
    by_ops = 1e6 * ops / H100_F32_OPS_PER_S
    return {"bound_us": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes_us": by_bytes, "operations_us": by_ops,
            "candidate_share": scans / max(interior, 1)}


def smoke_images(np, imgs) -> dict:
    """The timed cases: a fixture frame and uniform noise at both shapes."""
    rng = np.random.default_rng(7)
    frame = imgs[0].astype(np.float32)
    return {
        "180x320 frame": frame,
        "180x320 noise": rng.uniform(0, 255, (180, 320)).astype(np.float32),
        "480x752 frame": np.tile(frame, (3, 3))[:480, :752].copy(),
        "480x752 noise": rng.uniform(0, 255, (480, 752)).astype(np.float32),
    }


def check_against_plain(torch, fast, fast_cuda, img, ksize: int, label: str):
    """Both entry points on one CUDA image; returns the max errors of
    ``fast_detect``'s score (held to 0) and of the blur."""
    ks, kb = fast_cuda.detect_and_smooth(img, THRESHOLD, ksize)
    kd = fast_cuda.detect(img, THRESHOLD)
    ps, pb = fast.detect_and_smooth(img, THRESHOLD, ksize)
    torch.cuda.synchronize()
    for name, got in (("fast_detect_and_smooth", ks), ("fast_detect", kd)):
        if not torch.equal(got, ps):
            raise AssertionError(
                f"{label}: {name} score differs from plain at "
                f"{int((got != ps).sum())} pixels")
    err = float((kb - pb).abs().max())
    if not err <= BLUR_ATOL:
        raise AssertionError(f"{label}: blur error {err} > {BLUR_ATOL}")
    return float((kd - ps).abs().max()), err


def kernel_phase(torch, np, imgs):
    from mageslam_tpu_torch.ops import fast, fast_cuda
    rng = np.random.default_rng(11)
    board = (np.indices((64, 96)).sum(0) % 2 * 200.0).astype(np.float32)
    extra = {
        "37x61 noise": (rng.uniform(0, 255, (37, 61)).astype(np.float32), 7),
        "64x96 checkerboard": (board, 7),
        "90x122 noise, 3 taps": (rng.uniform(0, 255, (90, 122))
                                 .astype(np.float32), 3),
        "90x122 noise, 5 taps": (rng.uniform(0, 255, (90, 122))
                                 .astype(np.float32), 5),
    }
    worst = [0.0, 0.0]    # fast_detect's score, the blur
    for label, (arr, ksize) in extra.items():
        errs = check_against_plain(torch, fast, fast_cuda,
                                   torch.as_tensor(arr).cuda(), ksize, label)
        worst = [max(a, b) for a, b in zip(worst, errs)]
    print(f"[kernel] {len(extra)} extra cases: score exact, blur max|err| "
          f"{worst[1]:.3g}", flush=True)

    entries = {
        "fast_detect_and_smooth": (
            lambda im: fast_cuda.detect_and_smooth(im, THRESHOLD, 7),
            lambda im: fast.detect_and_smooth(im, THRESHOLD, 7), True),
        "fast_detect": (
            lambda im: fast_cuda.detect(im, THRESHOLD),
            lambda im: fast.detect(im, THRESHOLD), False),
    }
    report = {}
    for label, arr in smoke_images(np, imgs).items():
        img = torch.as_tensor(arr).cuda()
        errs = check_against_plain(torch, fast, fast_cuda, img, 7, label)
        worst = [max(a, b) for a, b in zip(worst, errs)]
        err = errs[1]
        floor_us = device_time_us(torch, lambda: fast_cuda.launch_floor(img))
        case = {"blur_max_abs_err": err, "floor_us": floor_us}
        for name, (kernel, plain, blur) in entries.items():
            turns = {"plain": [], "kernel": [], "device_us": []}
            for turn in ("plain", "kernel", "kernel", "plain"):
                if turn == "plain":
                    turns["plain"].append(time_ms(torch, lambda: plain(img)))
                else:
                    turns["kernel"].append(time_ms(torch,
                                                   lambda: kernel(img)))
                    turns["device_us"].append(device_time_us(
                        torch, lambda: kernel(img)))
            case[name] = {
                "ms": min(turns["kernel"]), "plain_ms": min(turns["plain"]),
                "device_us": min(turns["device_us"]), "turns": turns,
                **roofline_bound(fast, img, THRESHOLD, blur)}
            r = case[name]
            print(f"[kernel] {label} {name}: score exact, blur max|err| "
                  f"{err:.3g}; call {r['ms']:.4f} ms (plain "
                  f"{r['plain_ms']:.4f} ms); device {r['device_us']:.3f} us, "
                  f"empty kernel {floor_us:.3f} us, bound "
                  f"{r['bound_us']:.3f} us by {r['bound_by']} (candidates "
                  f"{100 * r['candidate_share']:.1f}% of pixels)",
                  flush=True)
        report[label] = case
    return report, worst


def make_engine(settings, z):
    from mageslam_tpu_torch.geometry.camera import CameraCalibration
    from mageslam_tpu_torch.runtime.fused import MageSlamTorchFused
    fx, fy, cx, cy, w, h = z["cal"].tolist()
    cal = CameraCalibration.pinhole(fx, fy, cx, cy, int(w), int(h))
    # no device argument: the entry point takes the card by default
    eng = MageSlamTorchFused(settings, cal, seed=1)
    if eng.device.type != "cuda":
        raise AssertionError(f"engine built on {eng.device}, not the card")
    return eng, cal


def engine_phase(torch, np, z):
    from mageslam_tpu_torch.io.evaluation import ate_rmse
    from mageslam_tpu_torch.ops import fast_cuda
    from mageslam_tpu_torch.runtime.results import TrackingState

    imgs, gt = z["imgs"], z["gt_poses"]
    eng, _ = make_engine(ref_settings_loop_off(), z)
    fast_cuda.reset_launch_counts()
    stamps = []
    t0 = time.perf_counter()
    for i, img in enumerate(imgs):
        eng.process_frame(img, timestamp=i / 30.0)
        stamps.append(time.perf_counter())
    results = eng.flush()
    syncs = eng.host_syncs
    fossil = eng.fossilize()
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    launches = fast_cuda.launch_counts()

    states = [results[i].state for i in range(len(imgs))]
    tracked = sum(s == TrackingState.TRACKING for s in states)
    if TrackingState.TRACKING not in states:
        raise AssertionError("engine never initialized")
    if tracked < int(z["ref_tracked"]) - 3:
        raise AssertionError(f"tracked {tracked} < JAX "
                             f"{int(z['ref_tracked'])} - 3")
    est, ref = [], []
    for i, r in enumerate(states):
        p = fossil.pose_for_frame(i)
        if r == TrackingState.TRACKING and p is not None:
            est.append(p)
            ref.append(gt[i])
    if not np.isfinite(fossil.poses).all() or not np.isfinite(
            np.stack([results[i].pose for i in range(len(imgs))
                      if results[i].pose is not None])).all():
        raise AssertionError("non-finite pose")
    if launches["fast_detect_and_smooth"] != len(imgs):
        raise AssertionError(f"kernel launches {launches} != "
                             f"{len(imgs)} frames")
    ate, _, gt_c = ate_rmse(np.asarray(est), np.asarray(ref))
    bound = float(z["ref_ate_bound"])
    if not ate < bound:
        raise AssertionError(f"ATE {ate} >= bound {bound}")
    steady = (len(imgs) - 21) / (stamps[-1] - stamps[19])
    extent = float(np.linalg.norm(gt_c.max(0) - gt_c.min(0)))
    print(f"[engine] tracked {tracked}/{len(imgs)} (JAX CPU "
          f"{int(z['ref_tracked'])}), keyframes {eng.num_keyframes}, map "
          f"points {eng.num_map_points}, ATE {ate:.5f} (bound {bound:.5f}, "
          f"extent {extent:.3f}), steady frames/s over frames 20-59 "
          f"{steady:.2f}, host syncs/frame {syncs / len(imgs):.2f} "
          f"(+1 output-row read), drive+fossilize {t_total:.1f} s, "
          f"launches {launches}", flush=True)
    return launches["fast_detect_and_smooth"]


def wide_blur_phase(torch, np, z):
    """The route that reaches ``fast_detect``: a blur wider than the fused
    kernel's 7 taps.  The drive must initialize and be tracking at its last
    frame."""
    from mageslam_tpu_torch.ops import fast_cuda
    from mageslam_tpu_torch.tracking import frontend

    settings = ref_settings_loop_off(gaussian_kernel_size=9)
    eng, cal = make_engine(settings, z)
    imgs = z["imgs"][:WIDE_BLUR_FRAMES]
    fast_cuda.reset_launch_counts()
    for i, img in enumerate(imgs):
        res = eng.process_frame(img, timestamp=i / 30.0)
        if res.pose is not None and not np.isfinite(res.pose).all():
            raise AssertionError(f"wide blur: non-finite pose at frame {i}")
    torch.cuda.synchronize()
    launches = fast_cuda.launch_counts()
    if launches["fast_detect"] != len(imgs) \
            or launches["fast_detect_and_smooth"] != 0:
        raise AssertionError(f"wide blur: launches {launches} for "
                             f"{len(imgs)} frames")
    # the frontend of this route on the card against the CPU's plain path
    F = settings.capacity.max_features
    gray = torch.as_tensor(imgs[3].astype(np.float32))
    fc = frontend.extract_for_settings(gray, cal, settings.mono.camera, F)
    fg = frontend.extract_for_settings(gray.cuda(), cal.to("cuda"),
                                       settings.mono.camera, F)
    if not torch.equal(fg.valid.cpu(), fc.valid) \
            or not torch.equal(fg.response.cpu(), fc.response):
        raise AssertionError("wide blur: keypoints differ from the CPU's")
    duv = float((fg.uv.cpu() - fc.uv).abs().max())
    if not duv <= 1e-4:
        raise AssertionError(f"wide blur: keypoint positions off by {duv}")
    states = [eng.result_for(i).state.name for i in range(len(imgs))]
    if states[-1] != "TRACKING":
        raise AssertionError(f"wide blur: not tracking after {len(imgs)} "
                             f"frames: {states}")
    print(f"[engine, 9-tap blur] {len(imgs)} frames, tracked "
          f"{states.count('TRACKING')}, {int(fc.valid.sum())} keypoints "
          f"equal to the CPU's (max |duv| {duv:.3g}), launches {launches}",
          flush=True)
    return launches["fast_detect"]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not FIXTURE.exists():
        print(f"chip_smoke: missing {FIXTURE}", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from mageslam_tpu_torch.ops import fast_cuda

    try:
        import triton  # noqa: F401
        has_triton = f"yes ({triton.__version__})"
    except ImportError:
        has_triton = "no"
    nvcc_ver = run_text([fast_cuda.nvcc_path(),
                         "--version"]).splitlines()[-1]
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    print(f"[toolchain] python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, torch.version.cuda {torch.version.cuda}, "
          f"nvcc: {nvcc_ver}, triton: {has_triton}, ninja: "
          f"{shutil.which('ninja') or 'no'}, gpu: {smi}", flush=True)

    t0 = time.perf_counter()
    fast_cuda.build(verbose=True)
    print(f"[build] {time.perf_counter() - t0:.2f} s (nvcc "
          f"{fast_cuda.build_seconds if fast_cuda.build_seconds else 0:.2f}"
          f" s) -> {fast_cuda.library_path().relative_to(ROOT)}",
          flush=True)

    z = np.load(FIXTURE)
    report, worst_err = kernel_phase(torch, np, z["imgs"])
    launches = {"fast_detect_and_smooth": engine_phase(torch, np, z),
                "fast_detect": wide_blur_phase(torch, np, z)}

    main_case = report["180x320 frame"]   # the main path's shape and data
    pallas = "mageslam_tpu/ops/fast_pallas.py"
    replaces = {"fast_detect_and_smooth": f"{pallas}:106",
                "fast_detect": f"{pallas}:80"}
    table = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": "mageslam_tpu_torch/csrc/fast_detect.cu",
        "replaces": replaces[name],
        "launches": launches[name],
        # the blur's error, and fast_detect's score error (held to 0)
        "max_abs_err": worst_err[name == "fast_detect_and_smooth"],
        "ms": main_case[name]["ms"],
        "plain_ms": main_case[name]["plain_ms"],
        "device_us": main_case[name]["device_us"],
        "floor_us": main_case["floor_us"],
        "bound_ms": 1e-3 * main_case[name]["bound_us"],
        "bound_us": main_case[name]["bound_us"],
        "bound_by": main_case[name]["bound_by"],
        # no single PyTorch call computes FAST + NMS (+ blur)
        "library_ms": None,
    } for name in ("fast_detect_and_smooth", "fast_detect")]}
    print(f"[cases] {json.dumps(report)}")
    print(smi)
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
