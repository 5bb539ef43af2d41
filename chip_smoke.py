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
   BA; loop closure and cheap loop closure on, the engine's defaults) over
   the 60-frame fixture ``tests/data/torch_orbit60.npz``, then
   ``fossilize``; checks that it initializes, tracks at least the JAX
   engine's count minus 3, yields finite poses, went through
   ``fast_detect_and_smooth`` once per frame, and keeps the Sim3-aligned
   ATE under the bound stored in the fixture;
6. the same engine with a 9-tap blur for 15 frames: the frontend then takes
   the plain blur and the ``fast_detect`` entry point, once per frame; it
   must initialize and end tracking, and the frontend's features on the
   card are held against the CPU's;
7. the ring: the same capacities with the ring's loop-closure settings
   (``ring_ref`` of ``tests/data/torch_ring150.npz``) over its 150 frames,
   eight of them blacked out.  The drive must report relocalizing inside
   the blackout, track again within 6 frames of the JAX engine's recovery,
   track at least its count minus 5, keep every pose finite and the ATE
   under the stored bound, and launch ``fast_detect_and_smooth`` once per
   frame.  Relocalizations and loop detections are timed one by one (host
   clock between device syncs);
8. the formal closure: the injected-drift map of the fixture carried onto
   the card, ``detect_loop`` -> the rigid and the pose-graph correction ->
   ``merge_loop_points`` -> ``global_bundle_adjust``, each stage timed;
   the loop must be found, its scale within 10% of the stored one, the
   keyframe ATE cut by at least 0.8x the stored cut, and
   ``util.argmax_first`` on the card must agree with the CPU's.  Prim's
   sweep and the pose-graph solve are also timed at full width, on the
   ring drive's final map (256 keyframe slots).

9. the multi-level drive: the 60-frame orbit at the fixture's 2-level
   setting (``ml_settings_json`` of ``tests/data/torch_facade.npz``: the
   reference shape with ``num_levels=2``, ``scale_factor=1.5``); tracked at
   least the JAX engine's count minus 3, ATE under 1.5x JAX's, and
   ``fast_detect_and_smooth`` twice per frame (180x320 and 120x213);
10. the facade: ``process_stereo_frames`` on the fixture's stereo pair
    (both results TRACKING, at least ``min_init_map_points`` map points,
    median depth within 5% of JAX's; ``stereo_initialize`` timed), then its
    30 mono frames through ``process_frame`` with an
    ``IMUPosePriorProvider`` fed the gyro samples and ``add_sensor_sample``
    fed the IMU stream (``use_fuser``), a ``Determinator`` recording and
    the mediator's events counted; tracked at least JAX's count minus 3,
    gravity within 2 degrees and scale within 5% of JAX's, and
    ``try_get_volume_of_interest`` returns a box;
11. a rectified frame: ``extract_for_settings`` with
    ``undistort_image_pixels`` on the fixture's distorted frame; its
    keypoints on the card against the CPU's and JAX's, and the feature count
    of the keypoint-undistortion route beside it.

12. the dataset: ``examples/console_torch.run`` (the console a user calls)
    on ``tests/data/mini_seq`` on the card, 40 EuRoC-format frames read
    from disk by the port's ``FramePump`` (its route, native or Python,
    printed with the build seconds), ``fast_settings()``; tracked at least
    the JAX console's count minus 3 with the last initializing frame
    before 20, the Sim3 ATE under 1.5x the worst of the JAX console's ATEs
    at seeds 1-3 (``tests/data/torch_dataset.npz``), the fossil CSV and
    TUM files written to a temporary directory and read back; then the
    pump decodes ``tests/data/ring_seq``'s 150 frames, which must equal
    the frames stored in ``torch_ring150.npz`` outside its blackout;
13. checkpoints: the orbit drive's state after frame 30 through
    ``io/serialization.save_state`` and ``load_state`` into a fresh
    engine's template, every tensor equal bit for bit; the JAX package's
    checkpoint stored in ``torch_dataset.npz`` loaded on the card, equal
    to ``convert.engine_state_from_npz`` of the same state.

14. the host engine's console: ``examples/console_torch.run`` with
    ``--host-engine`` (``MageSlamTorch`` on the card) on ``mini_seq``;
    tracked at least the JAX host console's smallest count at seeds 1-3
    minus 3, ATE under 1.5x its worst (``tests/data/torch_host.npz``), one
    launch per frame; a ``Determinator`` records its streams and
    ``utils/tracing.PROFILER`` times each ``process_frame`` (host clock);
15. the host engine at full width: ``MageSlamTorch`` over the 60-frame
    orbit at ``ref_settings()`` capacities, held to the JAX host engine's
    drive of the same frames (tracked minus 3, ATE under 1.5x);
16. record / replay: the console drive's frames written with the port's
    ``RecordingWriter``, read back with ``Recording`` and replayed through
    a fresh ``MageSlamTorch`` with a ``Determinator``: every channel's
    stream must equal the live drive's (a ``DataFlowLog`` per run names
    the first channel that differs); write and read timed;
17. the analysis consumers on the ring drive's final map (8192 point
    slots): ``knn_indices``, ``estimate_normals``, ``mollify_normals`` and
    ``reposition_points`` on the card against the same functions on the
    CPU (indices exactly; normals within 1e-3 where the covariance's
    smallest eigenvalue is separated from the next by 1e-3 of the
    largest; mollified normals 1e-5 and repositioned points 1e-5 of the
    coordinate, each fed the CPU's input), each timed; a ``SkeletonKey``
    snapshot of the ring engine, whose counts must equal the engine's; an
    ``Xray`` capture of one local-BA window and its JSON size.

18. the parallel layer (``mageslam_tpu_torch/parallel``), against the JAX
    package's results in ``tests/data/torch_parallel.npz`` and within its
    ``tol/*`` tolerances, each step timed on the host clock between
    device syncs: (a) distributed BA on an 8-shard mesh of ``cuda:0``, the
    certification problem (``multiprocess.run_certification``) and the
    ring drive's final map (8192 point slots) against the single-device
    BA on the card (poses 1e-4, points 1e-3, MSE relative 1e-3), directly
    and through ``engine_global_bundle_adjust``; (b) trajectory sharding:
    ``plan_from_map`` on the JAX engine's stored ring map (halo 2 and 1)
    with integer outputs equal to JAX's, the sharded solve (halo 2, 32
    tethers, min covisibility 5, 6 steps) within 3x the single-device MSE
    and within tolerance of JAX's, then the ring drive's map with the
    CPU's plan as the integers' reference; (c) ``spawn_certification(2,
    4)``, two processes over gloo with their shards on the card,
    bit-identical to each other and to the in-process run of (a); (d) a
    fleet of 8 sessions on ``cuda:0`` at ``ref_settings()`` capacities
    over 30 frames of 8 synthetic worlds: each tracks at least the JAX
    fleet's count minus 3, stream 0 equals a solo ``DeviceEngine`` in every
    slot of its output rows, 240 launches of ``fast_detect_and_smooth``.

19. the long session at keyframe capacity (``tests/data/torch_long640.npz``):
    ``tests/test_long_session.py``'s 640-frame slow double loop with 40
    keyframe slots, 2048 map points and a 1024-entry history, rendered on
    the host by the port's renderer (each frame's CRC-32 equal to the JAX
    renderer's) and driven twice through ``MageSlamTorchFused`` on the
    card, each drive launching ``fast_detect_and_smooth`` once per frame
    (640); the kernel must equal its plain version exactly (score and
    blur) on frames 0, 320 and 639.  The drive's outcome is set by its
    initial map (frame 3), and each drive is held to the JAX engine's
    drives from the same map: (a) from the port's own initialization.  Its
    map must be, within 1e-3 in the keyframe poses, either the JAX
    engine's at seed 1 (``init_post/``) or the one the card made when the
    fixture was written (``card_init/``: the homography's two candidates
    with equal cheirality counts are told apart by a reprojection term
    below float32's resolution, and the card takes the other one); it is
    then held to the JAX engine's drive from that map (``ci_*``: tracked
    at least its count minus 32, the last 50 frames at least its count
    minus 10, the history at least its count minus 32, the ATE under 1.5x
    its ATE), or, from JAX's map, as (b) is.  (b) Resumed from the JAX
    engine's state after its initialization
    (``convert.engine_state_from_npz``, as phase 13 loads a JAX
    checkpoint), so that keyframe creation runs past capacity: force cull,
    slot recycling, history re-anchoring, ``fossilize`` over a churned
    map.  It must track at least the JAX engine's lowest count over seeds
    1-3 minus 32 (5%) and 40 of the last 50 frames, create more than 40
    keyframes and keep at least 600 history entries, and keep the Sim3
    fossil ATE under 1.5x the worst of JAX's three.  Both must never hold
    more than 40 keyframes and keep their array shapes;
20. the bench and the port's programs: ``bench_torch.py --kernel-table`` and
    ``--device-step`` in fresh processes (their lines printed; two steps
    from clones of one state must be equal); ``bench.py``'s 250 frames
    rendered by the port, their CRC-32s equal to the JAX renderer's
    (``tests/data/torch_bench.npz``), and one bench drive at
    ``ref_settings()`` over the first 60 frames and one at
    ``fast_settings()`` over all 250 (``reset``, 50 warm-up frames, the
    rest timed): each initializes if and only if the JAX engine's drive
    did (over the same frames), its first tracking frame within 5 of
    JAX's, and tracks at least JAX's count minus 5, one launch per frame.
    Neither engine initializes at ``ref_settings()``, so that drive is a
    parity record; the ``fast_settings()`` drive is the one that fails a port
    that does not initialize.  The frame at which the map initializes is
    set by the initialization RANSAC's draws, which differ between
    ``jax.random`` and torch's CUDA generator, so over seeds 1-12 on the
    first 20 frames the median first tracking frame must lie within 3 of
    the JAX engine's over the same seeds (the launches of both drives and
    of the seeds count); ``examples/run_synthetic_torch.py`` at its
    defaults: tracked at least JAX's ``run_synthetic`` minus 3, ATE
    under 1.5x JAX's; then ``tools/bench_torch_matching.py`` at N=512,
    ``tools/bench_torch_scaling.py`` at 1 and 2 shards of L=2048,
    ``tools/profile_torch_frontend.py``, the feed phase of
    ``tools/profile_torch_engine.py`` and ``tools/make_dataset_torch.py``
    for 3 frames (where matplotlib is missing, ``io/real_texture`` raises
    ``ImportError`` and the tool is not run).

The facade runs at its default ``fetch_every`` (8): results resolve through
its fetch ring, and the prior provider, events and fuser fences follow its
timing; the phase holds the frames resolved per call and the frames that
got no prior to the JAX facade's drive of the same inputs (``nf_*``).

Phase 4 also runs both entry points on the pyramid levels of the fixture's
frames (120x213, 80x142, 320x501, 213x334: widths that are not a multiple
of four take the kernel's unaligned route), timed and bounded like the
others.

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
RING_FIXTURE = ROOT / "tests" / "data" / "torch_ring150.npz"
FACADE_FIXTURE = ROOT / "tests" / "data" / "torch_facade.npz"
DATASET_FIXTURE = ROOT / "tests" / "data" / "torch_dataset.npz"
HOST_FIXTURE = ROOT / "tests" / "data" / "torch_host.npz"
PARALLEL_FIXTURE = ROOT / "tests" / "data" / "torch_parallel.npz"
BENCH_FIXTURE = ROOT / "tests" / "data" / "torch_bench.npz"
LONG_FIXTURE = ROOT / "tests" / "data" / "torch_long640.npz"
MINI_SEQ = ROOT / "tests" / "data" / "mini_seq"
RING_SEQ = ROOT / "tests" / "data" / "ring_seq"
RING_BLACKOUT = range(130, 138)
CHECKPOINT_FRAME = 30
# the pyramid levels of the fixture frames that the kernel cases run on
LEVEL_CASES = {"120x213 level": "lv_180_f0_l1", "80x142 level": "lv_180_f0_l2",
               "320x501 level": "lv_480_f0_l1",
               "213x334 level": "lv_480_f0_l2"}
BLUR_ATOL = 2e-3
TIMING_RUNS = 60
GRAPH_LAUNCHES = 200
THRESHOLD = 10.0
WIDE_BLUR_FRAMES = 15
# the long session: tests/test_long_session.py's slow double loop
LONG_RADIUS, LONG_FRACTION = 3.0, 2.24
LONG_CHECK_FRAMES = (0, 320, 639)
# the bench's ref_settings() drive: 50 warm-up frames and 10 timed
REF_BENCH_FRAMES = 60

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


def ref_settings(gaussian_kernel_size: int = 7):
    """``bench_torch.ref_settings()`` (``bench.py``'s reference-shaped
    settings: the defaults, loop closure and cheap loop closure on, at 440
    features) with a ``gaussian_kernel_size``-tap blur."""
    from bench_torch import ref_settings as bench_ref_settings
    s = bench_ref_settings()
    mono = s.mono
    fe = dataclasses.replace(mono.camera.features,
                             gaussian_kernel_size=gaussian_kernel_size)
    cam = dataclasses.replace(mono.camera, features=fe)
    return s.replace(mono=dataclasses.replace(mono, camera=cam))


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


def smoke_images(np, imgs, levels) -> dict:
    """The timed cases: a fixture frame and uniform noise at both shapes,
    and the pyramid levels of the fixture frame at both shapes."""
    rng = np.random.default_rng(7)
    frame = imgs[0].astype(np.float32)
    return {
        "180x320 frame": frame,
        "180x320 noise": rng.uniform(0, 255, (180, 320)).astype(np.float32),
        "480x752 frame": np.tile(frame, (3, 3))[:480, :752].copy(),
        "480x752 noise": rng.uniform(0, 255, (480, 752)).astype(np.float32),
        **{label: levels[key] for label, key in LEVEL_CASES.items()},
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


def kernel_phase(torch, np, imgs, levels):
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
    for label, arr in smoke_images(np, imgs, levels).items():
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


def calibration(z, key: str = "cal"):
    """The camera a fixture was rendered with (``<key>_dist`` and
    ``<key>_model`` where it is distorted)."""
    import torch
    from mageslam_tpu_torch.geometry.camera import CameraCalibration
    fx, fy, cx, cy, w, h = z[key].tolist()
    if f"{key}_dist" not in z:
        return CameraCalibration.pinhole(fx, fy, cx, cy, int(w), int(h))
    return CameraCalibration(fx, fy, cx, cy, torch.as_tensor(z[f"{key}_dist"]),
                             int(z[f"{key}_model"]), int(w), int(h))


def make_engine(settings, z):
    from mageslam_tpu_torch.runtime.fused import MageSlamTorchFused
    cal = calibration(z)
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
    eng, _ = make_engine(ref_settings(), z)
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
          f"(+1 read per window of 8 output rows), loop detections "
          f"{eng.engine.counts['loop_detections']} run / "
          f"{eng.engine.counts['loop_no_candidates']} without a candidate, "
          f"cheap-loop-closure associations {eng.cheap_loop_associations}, "
          f"loops closed {eng.loops_closed}, drive+fossilize {t_total:.1f} s, "
          f"launches {launches}", flush=True)
    return launches["fast_detect_and_smooth"]


def wide_blur_phase(torch, np, z):
    """The route that reaches ``fast_detect``: a blur wider than the fused
    kernel's 7 taps.  The drive must initialize and be tracking at its last
    frame."""
    from mageslam_tpu_torch.ops import fast_cuda
    from mageslam_tpu_torch.tracking import frontend

    settings = ref_settings(gaussian_kernel_size=9)
    eng, cal = make_engine(settings, z)
    imgs = z["imgs"][:WIDE_BLUR_FRAMES]
    fast_cuda.reset_launch_counts()
    for i, img in enumerate(imgs):
        eng.process_frame(img, timestamp=i / 30.0)
    for i, res in eng.flush().items():
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


class SyncedTimer:
    """Stands in for a bound method of the engine and times each call: the
    host clock between two device syncs, in ms.  ``kind()`` labels a call
    after it returned."""

    def __init__(self, torch, fn, kind=lambda: ""):
        self.torch, self.fn, self.kind = torch, fn, kind
        self.calls = []          # (ms, label)

    def __call__(self, *args, **kwargs):
        out, ms = timed(self.torch, lambda: self.fn(*args, **kwargs))
        self.calls.append((ms, self.kind()))
        return out

    def ms(self, label: str = ""):
        return [t for t, k in self.calls if k == label]


def timed(torch, fn, warm: bool = False):
    """(result, ms) of one call between two device syncs, after one
    untimed call when ``warm``."""
    if warm:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def summary(ms) -> str:
    if not ms:
        return "none"
    ms = sorted(ms)
    return (f"{len(ms)} calls, median {ms[len(ms) // 2]:.1f} ms, "
            f"max {ms[-1]:.1f} ms")


def decode_frames(np, dy):
    """Frames stored as each image row's difference from the row above
    (mod 256), as the ring and facade fixtures store them."""
    return np.cumsum(dy, axis=1, dtype=np.uint8)


def seam_covisibility(np, eng, num_frames: int) -> int:
    """Map points shared between keyframes of the first 30 frames and of
    the last 30: above zero, the ring's seam is one covisible map."""
    from mageslam_tpu_torch.mapstore import map_state as ms
    m = eng.map_state
    mem = ms.member_matrix(m).cpu().numpy()
    fid = m.kf_frame_id.cpu().numpy()
    valid = m.kf_valid.cpu().numpy()
    early = valid & (fid >= 0) & (fid < 30)
    late = valid & (fid > num_frames - 30)
    return int((mem[early].any(0) & mem[late].any(0)).sum())


def ring_phase(torch, np, z):
    from mageslam_tpu_torch import MageSlamSettings
    from mageslam_tpu_torch.io.evaluation import ate_rmse
    from mageslam_tpu_torch.ops import fast_cuda
    from mageslam_tpu_torch.runtime import device_engine as de

    name = "ring_ref"
    imgs, gt = decode_frames(np, z["imgs_dy"]), z["gt_poses"]
    n = len(imgs)
    occ0, occ1 = (int(v) for v in z["occlusion"])
    settings = MageSlamSettings.from_json(str(z[f"{name}_settings_json"]))
    eng, _ = make_engine(settings, z)
    counts = eng.engine.counts
    seen = dict(counts)

    def loop_kind():
        ran = counts["loop_detections"] > seen["loop_detections"]
        seen.update(counts)
        return "detection" if ran else "no candidate"

    reloc = eng.engine.relocalize_frame = SyncedTimer(
        torch, eng.engine.relocalize_frame)
    loop = eng.engine.try_loop = SyncedTimer(torch, eng.engine.try_loop,
                                             loop_kind)
    fast_cuda.reset_launch_counts()
    stamps = []
    t0 = time.perf_counter()
    for i, img in enumerate(imgs):
        eng.process_frame(img, timestamp=float(z["timestamps"][i]))
        stamps.append(time.perf_counter())
    results = eng.flush()
    syncs = eng.host_syncs
    seam = seam_covisibility(np, eng, n)
    fossil = eng.fossilize()
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    launches = fast_cuda.launch_counts()

    codes = np.array([int(eng.output_row(i)[0]) for i in range(n)])
    tracking = codes == de.CODE_TRACKING
    lost = np.nonzero(codes == de.CODE_RELOCALIZING)[0]
    if not len(lost) or not occ0 <= lost[0] < occ1 + 2:
        raise AssertionError(f"ring: CODE_RELOCALIZING at frames {lost}, "
                             f"not inside the blackout {occ0}-{occ1 - 1}")
    if tracking[occ0 + 1:occ1].any():
        raise AssertionError("ring: a blacked-out frame was tracked")
    back = np.nonzero(tracking[occ1:])[0]
    want_back = int(z[f"{name}_recovery"])
    if not len(back) or occ1 + back[0] > want_back + 6:
        raise AssertionError(f"ring: tracking back at {occ1 + back[:1]}, "
                             f"JAX at {want_back}")
    recovery = occ1 + int(back[0])
    tracked = int(tracking.sum())
    if tracked < int(z[f"{name}_tracked"]) - 5:
        raise AssertionError(f"ring: tracked {tracked} < JAX "
                             f"{int(z[f'{name}_tracked'])} - 5")
    if counts["reloc_accepted"] < 1:
        raise AssertionError("ring: no relocalization was accepted")
    if launches["fast_detect_and_smooth"] != n:
        raise AssertionError(f"ring: kernel launches {launches} != {n}")
    poses = [results[i].pose for i in range(n) if results[i].pose is not None]
    if not np.isfinite(fossil.poses).all() \
            or not np.isfinite(np.stack(poses)).all():
        raise AssertionError("ring: non-finite pose")
    est, ref = [], []
    for i in range(n):
        p = fossil.pose_for_frame(i)
        if tracking[i] and p is not None:
            est.append(p)
            ref.append(gt[i])
    ate, _, gt_c = ate_rmse(np.asarray(est), np.asarray(ref))
    bound = float(z[f"{name}_ate_bound"])
    if not ate < bound:
        raise AssertionError(f"ring: ATE {ate} >= bound {bound}")
    extent = float(np.linalg.norm(gt_c.max(0) - gt_c.min(0)))
    before = (occ0 - 1 - 20) / (stamps[occ0 - 1] - stamps[20])
    after = (n - 1 - (recovery + 2)) / (stamps[-1] - stamps[recovery + 2])
    print(f"[ring] tracked {tracked}/{n} (JAX CPU "
          f"{int(z[f'{name}_tracked'])}), relocalizing from frame "
          f"{int(lost[0])}, tracking back at {recovery} (JAX {want_back}), "
          f"relocalizations tried {counts['reloc_tried']} accepted "
          f"{counts['reloc_accepted']}, cheap-loop-closure associations "
          f"{eng.cheap_loop_associations}, loops closed {eng.loops_closed}, "
          f"seam covisibility {seam} (JAX {int(z[f'{name}_seam_covis'])}), "
          f"keyframes {eng.num_keyframes}, map points {eng.num_map_points}, "
          f"ATE {ate:.5f} (bound {bound:.5f}, JAX seeds "
          f"{z[f'{name}_ate_seeds'].round(5).tolist()}, extent "
          f"{extent:.3f}), host syncs/frame {syncs / n:.2f} (+1 read per "
          f"window of 8 output rows), steady frames/s {before:.2f} over "
          f"frames 20-{occ0 - 1} "
          f"and {after:.2f} over frames {recovery + 2}-{n - 1}, "
          f"drive+fossilize {t_total:.1f} s, launches {launches}",
          flush=True)
    print(f"[ring] per relocalization: {summary(reloc.ms())}; per loop "
          f"attempt with a candidate (detect_loop ran): "
          f"{summary(loop.ms('detection'))}; gated out at the candidate "
          f"read: {summary(loop.ms('no candidate'))}", flush=True)
    return launches["fast_detect_and_smooth"], eng


def full_width_graph_times(torch, m, steps: int, min_covis: int):
    """Prim's sweep and the pose-graph solve on a map at full capacity
    (the ring drive's final one): edges measured at the current poses, so
    the solve starts converged — its cost does not depend on that: the
    normal equations are dense over all 7K unknowns at every step."""
    from mageslam_tpu_torch.geometry import sim3
    from mageslam_tpu_torch.mapstore import map_state as ms
    from mageslam_tpu_torch.mapstore import spanning_tree as stree
    from mageslam_tpu_torch.solvers import pose_graph as pg

    K = m.kf_valid.shape[0]
    cov = ms.covisibility(m)
    _, t_prim = timed(torch, lambda: stree.max_weight_spanning_tree(
        cov, m.kf_valid), warm=True)
    eg = stree.essential_graph_edges(m, min_covis=min_covis,
                                     max_covis_edges=4 * K, covis=cov)
    states = sim3.sim3_from_se3(m.kf_pose, 1.0)
    rel = sim3.sim3_compose(states[eg.edge_i.long()],
                            sim3.sim3_inverse(states[eg.edge_j.long()]))
    fixed = ~m.kf_valid
    fixed[int(torch.nonzero(m.kf_valid)[0])] = True
    problem = pg.PoseGraphProblem(states, fixed, eg.edge_i, eg.edge_j, rel,
                                  eg.edge_weight)
    res, t_solve = timed(torch, lambda: pg.optimize_pose_graph(
        problem, num_steps=steps), warm=True)
    if not torch.isfinite(res.states).all():
        raise AssertionError("pose graph at full width: non-finite states")
    print(f"[closure] at full width ({int(m.kf_valid.sum())} keyframes in "
          f"{K} slots): Prim's sweep ({K - 1} steps) {t_prim:.1f} ms, "
          f"optimize_pose_graph x{steps} ({eg.edge_i.shape[0]} edge slots, "
          f"{7 * K}^2 solve) {t_solve:.1f} ms", flush=True)


def closure_phase(torch, np, z, wide_map):
    from mageslam_tpu_torch import MageSlamSettings, convert
    from mageslam_tpu_torch.bow import database as bdb
    from mageslam_tpu_torch.io.evaluation import ate_rmse
    from mageslam_tpu_torch.loop import closure as lc
    from mageslam_tpu_torch.mapping import global_ba
    from mageslam_tpu_torch.mapstore import spanning_tree as stree
    from mageslam_tpu_torch.ops import util
    from mageslam_tpu_torch.runtime import device_engine as de
    from mageslam_tpu_torch.solvers import pose_graph as pg
    from mageslam_tpu_torch.solvers import sampling

    dev = torch.device("cuda")
    # first-maximum rule on the card: Prim's sweep, the RANSAC winner and
    # the winning candidate all rely on it
    g = torch.Generator(device=dev).manual_seed(5)
    ties = torch.randint(0, 4, (64, 257), generator=g, device=dev)
    first = util.argmax_first(ties, -1)
    if not torch.equal(first.cpu(), util.argmax_first(ties.cpu(), -1)):
        raise AssertionError("closure: argmax_first differs from the CPU's")
    builtin = int((torch.argmax(ties, -1) != first).sum())

    settings = MageSlamSettings.from_json(str(z["drift_settings_json"]))
    st = convert.engine_state_from_npz(z, "drift_state/", device=dev)
    cal = calibration(z, "drift_cal").to(dev)
    m, slot, gt = st.map, int(z["drift_slot"]), z["drift_gt"]
    fx = float(cal.fx)
    lcs = settings.loop_closure

    def kf_ate(mm) -> float:
        v = mm.kf_valid.cpu().numpy()
        fid = mm.kf_frame_id.cpu().numpy()[v]
        return float(ate_rmse(mm.kf_pose.cpu().numpy()[v], gt[fid])[0])

    sampler = sampling.generator_sampler(
        torch.Generator(device=dev).manual_seed(7))
    db = bdb.BowDatabase(st.vocab, st.kf_sig, st.kf_sig_valid)
    det, t_detect = timed(torch, lambda: lc.detect_loop(
        sampler, m, db, slot, lcs, settings.relocalization, fx), warm=True)
    if not bool(det.found):
        raise AssertionError("closure: the loop was not found")
    scale, want_scale = float(det.scale), float(z["drift_det_scale"])
    if abs(scale / want_scale - 1.0) > 0.1:
        raise AssertionError(f"closure: scale {scale} vs stored "
                             f"{want_scale}")
    before = kf_ate(m)
    steps = int(lcs.pose_graph_steps)
    min_covis = int(lcs.pose_graph_min_covis)
    px = 1.0 / fx
    ba = lcs.bundle_adjust
    ba_steps = max(int(ba.num_steps), 5)
    report = {}
    for mode, correct in (
            ("rigid", lambda: lc.apply_similarity_correction(m, slot, det)),
            ("pg", lambda: lc.pose_graph_loop_correction(
                m, slot, det, num_steps=steps, min_covis=min_covis))):
        m1, t_corr = timed(torch, correct, warm=True)
        m2, t_merge = timed(torch, lambda: lc.merge_loop_points(
            m1, slot, det, cal, lcs))
        (m3, _), t_ba = timed(torch, lambda: global_ba.global_bundle_adjust(
            m2, ba.huber_width * px, ba.max_outlier_error * px,
            num_steps=ba_steps, lam0=1e-4))
        after = kf_ate(m3)
        want_cut = float(z["drift_ate_before"]) \
            - float(z[f"drift_{mode}_ate_ba"])
        if before - after < 0.8 * want_cut:
            raise AssertionError(
                f"closure ({mode}): keyframe ATE {before} -> {after}, "
                f"stored cut {want_cut}")
        if not torch.isfinite(m3.kf_pose).all() \
                or not torch.isfinite(m3.mp_pos[m3.mp_valid]).all():
            raise AssertionError(f"closure ({mode}): non-finite map")
        report[mode] = (t_corr, t_merge, t_ba, kf_ate(m1), after)

    # the pose-graph correction's two sequential parts, timed inside one
    # more correction (closure.py reaches both through their modules)
    prim = stree.max_weight_spanning_tree
    solve = pg.optimize_pose_graph
    stree.max_weight_spanning_tree = SyncedTimer(torch, prim)
    pg.optimize_pose_graph = SyncedTimer(torch, solve)
    try:
        lc.pose_graph_loop_correction(m, slot, det, num_steps=steps,
                                      min_covis=min_covis)
        (t_prim, _), = stree.max_weight_spanning_tree.calls
        (t_solve, _), = pg.optimize_pose_graph.calls
    finally:
        stree.max_weight_spanning_tree = prim
        pg.optimize_pose_graph = solve
    K = m.kf_valid.shape[0]
    edges = int((stree.essential_graph_edges(
        m, min_covis=min_covis, max_covis_edges=4 * K).edge_weight > 0).sum())

    # the same closure through the engine's loop block
    eng = de.DeviceEngine(settings, cal, seed=7)
    st2, t_try = timed(torch, lambda: eng.try_loop(
        st, torch.tensor(slot, device=dev)))
    if int(st2.loops_closed) != int(st.loops_closed) + 1:
        raise AssertionError("closure: try_loop did not close the loop")
    print(f"[closure] {int(m.kf_valid.sum())} keyframes, "
          f"{int(m.mp_valid.sum())} map points (capacity {K} / "
          f"{m.mp_valid.shape[0]}): found, loop keyframe {int(det.loop_kf)} "
          f"(stored {int(z['drift_det_loop_kf'])}), {int(det.num_inliers)} "
          f"inliers, scale {scale:.4f} (stored {want_scale:.4f}); keyframe "
          f"ATE {before:.4f}; detect_loop {t_detect:.1f} ms", flush=True)
    for mode, (t_corr, t_merge, t_ba, a1, a3) in report.items():
        print(f"[closure] {mode}: correction {t_corr:.1f} ms (ATE "
              f"{a1:.4f}), merge_loop_points {t_merge:.1f} ms, "
              f"global_bundle_adjust x{ba_steps} {t_ba:.1f} ms (ATE "
              f"{a3:.4f}; stored after 25 steps "
              f"{float(z[f'drift_{mode}_ate_ba']):.4f})", flush=True)
    print(f"[closure] inside the pose-graph correction: Prim's sweep "
          f"({K - 1} steps) {t_prim:.1f} ms, optimize_pose_graph x{steps} "
          f"({edges} edges, {7 * K}^2 solve) "
          f"{t_solve:.1f} ms; DeviceEngine.try_loop in all {t_try:.1f} ms "
          f"(ATE {kf_ate(st2.map):.4f}); torch.argmax on the card differs "
          f"from the first-maximum rule in {builtin} of 64 tied rows",
          flush=True)
    full_width_graph_times(torch, wide_map, steps, min_covis)


def sim3_ate(np, fossil, codes, gt, tracking_code: int = 2):
    """ATE of the fossilized poses of the tracked frames."""
    from mageslam_tpu_torch.io.evaluation import ate_rmse
    est, ref = [], []
    for i, c in enumerate(codes):
        p = fossil.pose_for_frame(i)
        if c == tracking_code and p is not None:
            est.append(p)
            ref.append(gt[i])
    ate, _, gt_c = ate_rmse(np.asarray(est), np.asarray(ref))
    return ate, float(np.linalg.norm(gt_c.max(0) - gt_c.min(0)))


def multilevel_phase(torch, np, z, f):
    """The orbit at two pyramid levels: every frame runs the kernel on its
    180x320 image and on the 120x213 level."""
    from mageslam_tpu_torch import MageSlamSettings
    from mageslam_tpu_torch.ops import fast_cuda

    settings = MageSlamSettings.from_json(str(f["ml_settings_json"]))
    eng, _ = make_engine(settings, z)
    imgs = z["imgs"]
    n = len(imgs)
    fast_cuda.reset_launch_counts()
    stamps = []
    for i, img in enumerate(imgs):
        eng.process_frame(img, timestamp=i / 30.0)
        stamps.append(time.perf_counter())
    eng.flush()
    syncs = eng.host_syncs
    fossil = eng.fossilize()
    torch.cuda.synchronize()
    launches = fast_cuda.launch_counts()
    by_shape = fast_cuda.launch_counts_by_shape()
    codes = [int(eng.output_row(i)[0]) for i in range(n)]
    tracked = codes.count(2)
    want = int(f["ml_tracked"])
    if tracked < want - 3:
        raise AssertionError(f"multi-level: tracked {tracked} < JAX {want} "
                             "- 3")
    name = "fast_detect_and_smooth"
    if launches[name] != 2 * n or by_shape.get((name, 120, 213)) != n:
        raise AssertionError(f"multi-level: launches {by_shape} for {n} "
                             "frames at two levels")
    if not np.isfinite(fossil.poses).all():
        raise AssertionError("multi-level: non-finite pose")
    ate, extent = sim3_ate(np, fossil, codes, z["gt_poses"])
    bound = float(f["ml_ate_bound"])
    if not ate < bound:
        raise AssertionError(f"multi-level: ATE {ate} >= bound {bound}")
    steady = (n - 21) / (stamps[-1] - stamps[19])
    print(f"[multi-level] 2 levels at scale 1.5: tracked {tracked}/{n} (JAX "
          f"CPU {want}), keyframes {eng.num_keyframes}, map points "
          f"{eng.num_map_points}, ATE {ate:.5f} (bound 1.5 x JAX "
          f"{float(f['ml_ate']):.5f} = {bound:.5f}, extent {extent:.3f}), "
          f"steady frames/s over frames 20-59 {steady:.2f}, host syncs/frame "
          f"{syncs / n:.2f} (+1 read per window of 8 output rows), kernel "
          f"launches {launches[name] / n:.0f} per frame ({by_shape})",
          flush=True)
    return launches


def facade_phase(torch, np, f):
    """Stereo bootstrap, then mono tracking with the IMU prior, the fuser,
    the mediator and a determinism recording; the volume of interest."""
    from mageslam_tpu_torch import MageSlamSettings
    from mageslam_tpu_torch.fuser.samples import SensorSample
    from mageslam_tpu_torch.mapstore.volume_of_interest import \
        compute_volume_of_interest
    from mageslam_tpu_torch.ops import fast_cuda
    from mageslam_tpu_torch.runtime.fused import MageSlamTorchFused
    from mageslam_tpu_torch.tracking import stereo
    from mageslam_tpu_torch.tracking.pose_priors import IMUPosePriorProvider
    from mageslam_tpu_torch.utils.determinism import Determinator
    from mageslam_tpu_torch.utils import mediator as med

    settings = MageSlamSettings.from_json(str(f["st_settings_json"]))
    prov = IMUPosePriorProvider()
    det = Determinator()
    eng = MageSlamTorchFused(settings, calibration(f, "st_cal"), seed=1,
                             pose_prior_provider=prov, determinator=det)
    if eng.device.type != "cuda":
        raise AssertionError(f"facade built on {eng.device}, not the card")
    events = {}
    for kind in (med.AnalysisCompleted, med.PoseRefined, med.TrackingLost):
        events[kind.__name__] = 0
        eng.mediator.subscribe(kind, lambda e, k=kind.__name__:
                               events.__setitem__(k, events[k] + 1))
    pair = decode_frames(np, f["st_pair_dy"])
    mono = decode_frames(np, f["st_mono_dy"])
    extr = f["st_extrinsics"]
    init = stereo.stereo_initialize = SyncedTimer(torch,
                                                  stereo.stereo_initialize)
    fast_cuda.reset_launch_counts()
    (r1, r2), t_pair = timed(torch, lambda: eng.process_stereo_frames(
        pair[0], pair[1], extr, timestamp=0.0))
    states = [r1.state.value, r2.state.value]
    if states != ["tracking", "tracking"]:
        raise AssertionError(f"facade: stereo results {states}")
    m = eng.map_state
    pts = m.mp_pos[m.mp_valid].cpu().numpy()
    depth, want_depth = float(np.median(pts[:, 2])), \
        float(f["st_median_depth"])
    if len(pts) < settings.stereo.map_init.min_init_map_points:
        raise AssertionError(f"facade: {len(pts)} map points")
    if abs(depth / want_depth - 1.0) > 0.05:
        raise AssertionError(f"facade: median depth {depth} vs JAX "
                             f"{want_depth}")
    stream, ts = f["st_imu"], f["st_ts"]
    ask, no_prior = prov.get_pose_for_time, []

    def get_pose_for_time(t):
        p = ask(t)
        no_prior.append(p is None)
        return p
    prov.get_pose_for_time = get_pose_for_time
    fed, stamps, resolved, seen = 0, [], [], set(eng._results)
    for i, img in enumerate(mono):
        while fed < len(stream) and stream[fed, 0] <= ts[i] + 1e-9:
            t, ax, ay, az, wx, wy, wz = stream[fed]
            eng.add_sensor_sample(SensorSample.accel(t, (ax, ay, az)))
            eng.add_sensor_sample(SensorSample.gyro(t, (wx, wy, wz)))
            prov.add_sample(t, (wx, wy, wz))
            fed += 1
        eng.process_frame(img, timestamp=float(ts[i]))
        stamps.append(time.perf_counter())
        resolved.append(len(set(eng._results) - seen))
        seen = set(eng._results)
    results = eng.flush()
    # a direct call without a device takes the card
    kf = eng.map_state.kf_pose[eng.map_state.kf_valid]
    n_kf = kf.shape[0]
    direct = compute_volume_of_interest(
        kf.cpu().numpy(), np.ones(n_kf), np.full(n_kf, 3.0),
        np.ones(n_kf, bool))
    if not direct.valid:
        raise AssertionError("facade: compute_volume_of_interest without a "
                             "device found no box")
    # the fetch ring's timing, as the JAX facade's drive without flush()
    if resolved != f["nf_resolved"].tolist() \
            or no_prior != np.isnan(f["nf_priors"][:, 0]).tolist():
        raise AssertionError(f"facade: resolved per call {resolved}, "
                             f"frames without a prior {no_prior}: not the "
                             "JAX facade's timing")
    voi, t_voi = timed(torch, eng.try_get_volume_of_interest)
    launches = fast_cuda.launch_counts()
    n = len(mono)
    tracked = sum(results[i + 1].state.value == "tracking" for i in range(n))
    if tracked < int(f["nf_tracked"]) - 3:
        raise AssertionError(f"facade: tracked {tracked} < JAX "
                             f"{int(f['nf_tracked'])} - 3")
    g, scale = eng.get_gravity_direction(), eng.get_scale()
    if g is None or scale is None:
        raise AssertionError("facade: the fuser did not converge")
    angle = float(np.degrees(np.arccos(np.clip(
        np.dot(g, f["nf_gravity"]), -1.0, 1.0))))
    if angle > 2.0 or abs(scale / float(f["nf_scale"]) - 1.0) > 0.05:
        raise AssertionError(f"facade: gravity {g} ({angle:.3f} deg off), "
                             f"scale {scale} vs JAX {float(f['nf_scale'])}")
    if voi is None or not (voi.max_corner > voi.min_corner).all():
        raise AssertionError(f"facade: volume of interest {voi}")
    if launches["fast_detect_and_smooth"] != 2 + n:
        raise AssertionError(f"facade: launches {launches} for a pair and "
                             f"{n} frames")
    poses = [results[i + 1].pose for i in range(n)
             if results[i + 1].pose is not None]
    if not np.isfinite(np.stack(poses)).all():
        raise AssertionError("facade: non-finite pose")
    steady = (n - 11) / (stamps[-1] - stamps[9])
    (t_init, _), = init.calls
    print(f"[facade] stereo pair: {states}, poses {r1.pose.round(6).tolist()}"
          f" / {r2.pose.round(6).tolist()}; {len(pts)} map points (JAX "
          f"{int(f['st_map_points'])}), median depth {depth:.4f} (JAX "
          f"{want_depth:.4f}); process_stereo_frames {t_pair:.1f} ms, of it "
          f"stereo_initialize {t_init:.1f} ms "
          f"({4 * settings.stereo.map_init.bundle_adjust.num_steps + 4} LM "
          f"steps)", flush=True)
    print(f"[facade] mono, fetch_every 8: tracked {tracked}/{n} (JAX "
          f"{int(f['nf_tracked'])}), resolved per call {resolved} (as "
          f"JAX's), {sum(no_prior)} frames without a prior (as JAX's), "
          f"steady frames/s over frames 10-{n - 1} "
          f"{steady:.2f}; gravity {np.round(g, 5).tolist()} (JAX "
          f"{np.round(f['nf_gravity'], 5).tolist()}, {angle:.4f} deg apart), "
          f"scale {scale:.5f} (JAX {float(f['nf_scale']):.5f}); volume of "
          f"interest {np.round(voi.min_corner, 4).tolist()} - "
          f"{np.round(voi.max_corner, 4).tolist()} (JAX "
          f"{np.round(f['nf_voi'], 4).tolist()}) in {t_voi:.1f} ms, a "
          f"direct compute_volume_of_interest with no device on "
          f"the card; "
          f"keyframes {eng.num_keyframes} (JAX {int(f['nf_keyframes'])}), "
          f"map points {eng.num_map_points} (JAX "
          f"{int(f['nf_map_points'])}); events "
          f"{events}; determinism streams {len(det.streams)} x "
          f"{len(det.streams['FusedEngine'])}; launches {launches}",
          flush=True)
    return launches


def rectified_phase(torch, np, f):
    """``undistort_image_pixels`` through ``extract_for_settings``: the
    rectified frame's keypoints on the card against the CPU's (the plain
    versions) and JAX's."""
    import dataclasses as dc
    from mageslam_tpu_torch import MageSlamSettings
    from mageslam_tpu_torch.ops import fast_cuda
    from mageslam_tpu_torch.tracking.frontend import extract_for_settings

    settings = MageSlamSettings.from_json(str(f["st_settings_json"]))
    F = settings.capacity.max_features
    rect_cam = dc.replace(settings.mono.camera, undistort_image_pixels=True)
    cal = calibration(f, "ud_cal")
    img = torch.as_tensor(f["ud_img"]).to(torch.float32)
    fast_cuda.reset_launch_counts()
    fg = extract_for_settings(img.cuda(), cal.to("cuda"), rect_cam, F)
    torch.cuda.synchronize()
    launches = fast_cuda.launch_counts()
    if launches["fast_detect_and_smooth"] != 1:
        raise AssertionError(f"rectified: launches {launches}")
    fc = extract_for_settings(img, cal, rect_cam, F)
    fk = extract_for_settings(img.cuda(), cal.to("cuda"),
                              settings.mono.camera, F)

    def keys(uv, valid):
        return {(round(float(u), 2), round(float(v), 2))
                for (u, v), ok in zip(uv.tolist(), valid.tolist()) if ok}

    kg = keys(fg.uv.cpu(), fg.valid.cpu())
    kc = keys(fc.uv, fc.valid)
    kj = keys(f["ud_feat/uv"], f["ud_feat/valid"])
    if len(kg & kc) < 0.99 * len(kc) or len(kg & kj) < 0.99 * len(kj):
        raise AssertionError(f"rectified: {len(kg)} keypoints on the card, "
                             f"{len(kg & kc)} of the CPU's {len(kc)}, "
                             f"{len(kg & kj)} of JAX's {len(kj)}")
    print(f"[rectified] {len(kg)} features on the rectified frame ("
          f"{len(kg & kc)} of the CPU's {len(kc)} at the same place, "
          f"{len(kg & kj)} of JAX's {len(kj)}); the keypoint-undistortion "
          f"route on the same card: {int(fk.valid.sum())} features; "
          f"launches {launches}", flush=True)
    return launches


def dataset_phase(torch, np, d, ring):
    """The console's golden path from disk, then the pump's decode of the
    ring sequence against the stored frames."""
    import tempfile
    sys.path.insert(0, str(ROOT / "examples"))
    import console_torch
    from mageslam_tpu_torch.io import native_loader
    from mageslam_tpu_torch.io.datasets import load_dataset
    from mageslam_tpu_torch.ops import fast_cuda
    from mageslam_tpu_torch.runtime.results import TrackingState

    t0 = time.perf_counter()
    route = native_loader.backend()
    t_route = time.perf_counter() - t0
    if route != "native":
        print(f"[dataset] native frame pump not built: "
              f"{native_loader.build_error}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        csv, tum = Path(tmp) / "fossil.csv", Path(tmp) / "traj.tum"
        args = console_torch.parse_args(["--dataset", str(MINI_SEQ), "--csv",
                                         str(csv), "--tum", str(tum)])
        fast_cuda.reset_launch_counts()
        out = console_torch.run(args)
        torch.cuda.synchronize()
        launches = fast_cuda.launch_counts()
        eng, fossil, n = out["engine"], out["fossil"], out["count"]
        if eng.device.type != "cuda" or out["source"] != route:
            raise AssertionError(f"dataset: engine on {eng.device}, frames "
                                 f"from {out['source']}")
        states = [out["results"][i].state for i in range(n)]
        last_init = max(i for i, st in enumerate(states)
                        if st == TrackingState.INITIALIZING)
        want = int(d["con_tracked"][0])
        if n != 40 or out["tracked"] < want - 3 or last_init >= 20:
            raise AssertionError(f"dataset: tracked {out['tracked']}/{n} "
                                 f"(JAX {want}), last initializing frame "
                                 f"{last_init}")
        bound = float(d["con_ate_bound"])
        if out["ate"] is None or not out["ate"] < bound:
            raise AssertionError(f"dataset: ATE {out['ate']} >= {bound}")
        if launches["fast_detect_and_smooth"] != n:
            raise AssertionError(f"dataset: launches {launches} for {n} "
                                 "frames")
        rows = np.loadtxt(csv, delimiter=",", ndmin=2)
        mats = fossil.world_from_camera_mats().reshape(-1, 16)
        traj = np.loadtxt(tum, ndmin=2)
        if rows.shape != (len(fossil.frame_ids), 17) \
                or not (rows[:, 0] == fossil.frame_ids).all() \
                or not np.allclose(rows[:, 1:], mats, rtol=1e-6, atol=1e-7) \
                or traj.shape != (len(fossil.frame_ids), 8) \
                or not np.allclose(traj[:, 0], fossil.timestamps, atol=1e-6):
            raise AssertionError(f"dataset: CSV {rows.shape} / TUM "
                                 f"{traj.shape} do not read back as the "
                                 f"fossil's {len(fossil.frame_ids)} poses")
    stamps = out["stamps"]
    steady = (n - 21) / (stamps[-1] - stamps[19])
    print(f"[dataset] mini_seq from disk: frame pump {route} (build "
          f"{native_loader.build_seconds or 0:.2f} s, first use "
          f"{t_route:.2f} s), tracked {out['tracked']}/{n} (JAX console "
          f"{d['con_tracked'].tolist()} at seeds 1-3), last initializing "
          f"frame {last_init} (JAX {int(d['con_last_init'][0])}), ATE "
          f"{out['ate']:.5f} (bound 1.5 x JAX's worst "
          f"{float(d['con_ate'].max()):.5f} = {bound:.5f}), steady "
          f"frames/s over frames 20-39 {steady:.2f}, host syncs/frame "
          f"{eng.host_syncs / n:.2f}, launches {launches}, keyframes "
          f"{eng.num_keyframes}, map points {eng.num_map_points}; CSV "
          f"{rows.shape[0]} rows and TUM {traj.shape[0]} rows read back",
          flush=True)

    paths = load_dataset(str(RING_SEQ)).image_paths
    stored = decode_frames(np, ring["imgs_dy"])
    t0 = time.perf_counter()
    frames = dict(native_loader.FramePump(paths, 320, 180))
    t_ring = time.perf_counter() - t0
    keep = [i for i in range(len(stored)) if i not in RING_BLACKOUT]
    bad = [i for i in keep if i not in frames
           or not np.array_equal(frames[i], stored[i].astype(np.float32))]
    if len(frames) != len(paths) or len(paths) != len(stored) or bad:
        raise AssertionError(f"dataset: ring_seq decode: {len(frames)} of "
                             f"{len(paths)} frames, differing {bad}")
    print(f"[dataset] ring_seq: {len(frames)} frames decoded by the "
          f"{route} pump in {t_ring:.2f} s, {len(keep)} outside the "
          f"blackout equal to the stored frames", flush=True)
    return launches


def checkpoint_phase(torch, np, z, d):
    """``save_state`` / ``load_state`` on the card, both directions of the
    JAX package's format."""
    import tempfile
    from mageslam_tpu_torch import convert
    from mageslam_tpu_torch.io import serialization
    from mageslam_tpu_torch.ops import fast_cuda
    from mageslam_tpu_torch.runtime import device_engine as de
    sys.path.insert(0, str(ROOT / "examples"))
    import console_torch

    def leaves(obj, prefix=""):
        if hasattr(obj, "_fields"):
            for name in obj._fields:
                yield from leaves(getattr(obj, name), f"{prefix}{name}/")
        else:
            yield prefix.rstrip("/"), obj

    def differing(a, b):
        return [k for (k, x), (_, y) in zip(leaves(a), leaves(b))
                if x.dtype != y.dtype or x.device != y.device
                or not torch.equal(x, y)]

    settings = ref_settings()
    eng, _ = make_engine(settings, z)
    fast_cuda.reset_launch_counts()
    for i, img in enumerate(z["imgs"][:CHECKPOINT_FRAME + 1]):
        eng.process_frame(img, timestamp=i / 30.0)
    eng.flush()
    launches = fast_cuda.launch_counts()
    st = eng.state
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "orbit.npz"
        _, t_save = timed(torch, lambda: serialization.save_state(
            str(path), st, {"frame": CHECKPOINT_FRAME}))
        size = path.stat().st_size
        fresh, _ = make_engine(settings, z)
        loaded, t_load = timed(torch, lambda: serialization.load_state(
            str(path), fresh.state))
        bad = differing(st, loaded)
        n_leaves = len(list(leaves(st)))
        jpath = Path(tmp) / "jax.npz"
        jpath.write_bytes(d["ckpt_bytes"].tobytes())
        template = de.empty_state(console_torch.fast_settings())
        from_jax = serialization.load_state(str(jpath), template)
        want = convert.engine_state_from_npz(d, "cs_state/", device="cuda")
        bad_jax = differing(want, from_jax)
    if bad or bad_jax or launches["fast_detect_and_smooth"] != \
            CHECKPOINT_FRAME + 1:
        raise AssertionError(f"checkpoint: round trip differs in {bad}, "
                             f"the JAX checkpoint in {bad_jax}, launches "
                             f"{launches}")
    print(f"[checkpoint] orbit state after frame {CHECKPOINT_FRAME} "
          f"({eng.num_keyframes} keyframes): {n_leaves} tensors equal bit "
          f"for bit after save ({t_save:.1f} ms, {size / 1e6:.2f} MB) and "
          f"load into a fresh engine's template ({t_load:.1f} ms); the JAX "
          f"checkpoint of the console drive's state after frame "
          f"{int(d['cs_frame'])} loads on the card equal to the stored "
          f"leaves; launches {launches}", flush=True)
    return launches

def host_console_phase(torch, np, h):
    """The console with ``--host-engine``: ``MageSlamTorch`` on the card
    over ``mini_seq`` from disk, a ``Determinator`` recording its streams
    and ``utils/tracing.PROFILER`` timing each ``process_frame``."""
    import tempfile
    sys.path.insert(0, str(ROOT / "examples"))
    import console_torch
    from mageslam_tpu_torch.ops import fast_cuda
    from mageslam_tpu_torch.runtime.slam import MageSlamTorch
    from mageslam_tpu_torch.utils import tracing
    from mageslam_tpu_torch.utils.determinism import Determinator

    det = Determinator()
    tracing.PROFILER.enabled = True
    tracing.PROFILER.stats.clear()
    with tempfile.TemporaryDirectory() as tmp:
        args = console_torch.parse_args([
            "--dataset", str(MINI_SEQ), "--host-engine",
            "--csv", str(Path(tmp) / "fossil.csv")])
        fast_cuda.reset_launch_counts()
        try:
            out = console_torch.run(args, determinator=det)
        finally:
            tracing.PROFILER.enabled = False
        torch.cuda.synchronize()
        launches = fast_cuda.launch_counts()
    eng, n = out["engine"], out["count"]
    if not isinstance(eng, MageSlamTorch) or eng.device.type != "cuda":
        raise AssertionError(f"host console: {type(eng).__name__} on "
                             f"{getattr(eng, 'device', None)}")
    want = int(h["con_tracked"].min())
    bound = float(h["con_ate_bound"])
    if n != 40 or out["tracked"] < want - 3:
        raise AssertionError(f"host console: tracked {out['tracked']}/{n} "
                             f"(JAX host console at least {want})")
    if out["ate"] is None or not out["ate"] < bound:
        raise AssertionError(f"host console: ATE {out['ate']} >= {bound}")
    if launches["fast_detect_and_smooth"] != n:
        raise AssertionError(f"host console: launches {launches} for {n} "
                             "frames")
    poses = [r.pose for r in out["results"].values() if r.pose is not None]
    if not np.isfinite(np.stack(poses)).all() \
            or not np.isfinite(out["fossil"].poses).all():
        raise AssertionError("host console: non-finite pose")
    stamps = out["stamps"]
    steady = (n - 21) / (stamps[-1] - stamps[19])
    print(f"[host console] MageSlamTorch on mini_seq from disk "
          f"({out['source']} pump): tracked {out['tracked']}/{n} (JAX host "
          f"console {h['con_tracked'].tolist()} at seeds 1-3), ATE "
          f"{out['ate']:.5f} (bound 1.5 x JAX's worst "
          f"{float(h['con_ate'].max()):.5f} = {bound:.5f}), keyframes "
          f"{eng.num_keyframes}, map points {eng.num_map_points}, steady "
          f"frames/s over frames 20-39 {steady:.2f}, launches {launches}; "
          f"determinism streams {len(det.streams)} channels, "
          f"{sum(map(len, det.streams.values()))} checkpoints", flush=True)
    print("[host console] utils/tracing scopes (host clock: launch, not "
          "device, time):\n" + tracing.PROFILER.report(), flush=True)
    return launches, det


def host_full_width_phase(torch, np, z, h):
    """``MageSlamTorch`` over the 60-frame orbit at ``ref_settings()``
    capacities (440 features, 256 keyframes, 8192 points), held to the JAX
    host engine's drive of the same frames."""
    from mageslam_tpu_torch import MageSlamSettings
    from mageslam_tpu_torch.ops import fast_cuda
    from mageslam_tpu_torch.runtime.slam import MageSlamTorch

    settings = MageSlamSettings.from_json(str(h["orb_settings_json"]))
    eng = MageSlamTorch(settings, calibration(z), seed=1)
    if eng.device.type != "cuda":
        raise AssertionError(f"host engine built on {eng.device}")
    imgs = z["imgs"]
    n = len(imgs)
    fast_cuda.reset_launch_counts()
    stamps, codes = [], []
    for i, img in enumerate(imgs):
        r = eng.process_frame(img, timestamp=i / 30.0)
        codes.append(2 if r.state.value == "tracking" else 0)
        stamps.append(time.perf_counter())
    fossil, t_fossil = timed(torch, eng.fossilize)
    launches = fast_cuda.launch_counts()
    tracked = codes.count(2)
    want = int(h["orb_tracked"])
    if tracked < want - 3:
        raise AssertionError(f"host orbit: tracked {tracked} < JAX {want} "
                             "- 3")
    if launches["fast_detect_and_smooth"] != n:
        raise AssertionError(f"host orbit: launches {launches} for {n} "
                             "frames")
    if not np.isfinite(fossil.poses).all():
        raise AssertionError("host orbit: non-finite pose")
    ate, extent = sim3_ate(np, fossil, codes, z["gt_poses"])
    bound = float(h["orb_ate_bound"])
    if not ate < bound:
        raise AssertionError(f"host orbit: ATE {ate} >= bound {bound}")
    steady = (n - 21) / (stamps[-1] - stamps[19])
    cap = settings.capacity
    print(f"[host orbit] MageSlamTorch at {cap.max_features} feature "
          f"slots, {cap.max_keyframes} keyframes, {cap.max_map_points} "
          f"points: tracked {tracked}/{n} (JAX host {want}), keyframes "
          f"{eng.num_keyframes} (JAX {int(h['orb_keyframes'])}), map points "
          f"{eng.num_map_points}, ATE {ate:.5f} (bound 1.5 x JAX "
          f"{float(h['orb_ate']):.5f} = {bound:.5f}, extent {extent:.3f}), "
          f"steady frames/s over frames 20-59 {steady:.2f}, fossilize "
          f"{t_fossil:.1f} ms, launches {launches}", flush=True)
    return launches


def record_replay_phase(torch, np, live):
    """The console drive's frames written with the port's
    ``RecordingWriter``, replayed through ``MageSlamTorch`` with a
    ``Determinator``: its streams must equal the live drive's, channel for
    channel."""
    import tempfile
    sys.path.insert(0, str(ROOT / "examples"))
    import console_torch
    from mageslam_tpu_torch.io.datasets import load_dataset
    from mageslam_tpu_torch.io.native_loader import FramePump
    from mageslam_tpu_torch.io.recording import Recording, RecordingWriter
    from mageslam_tpu_torch.ops import fast_cuda
    from mageslam_tpu_torch.runtime.slam import MageSlamTorch
    from mageslam_tpu_torch.utils.determinism import Determinator
    from mageslam_tpu_torch.utils.xray import DataFlow, DataFlowLog

    seq = load_dataset(str(MINI_SEQ))
    cal = seq.tracking_calibration(320)
    frames = list(FramePump(seq.image_paths, 320, cal.height))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with RecordingWriter(tmp, {"dataset": "mini_seq"}) as w:
            w.add_frame_stream(cal.height, 320)
            for i, img in frames:
                w.append("frames", float(seq.timestamps[i]
                                         - seq.timestamps[0]),
                         img.astype(np.uint8))
        t_write = 1e3 * (time.perf_counter() - t0)
        size = sum(p.stat().st_size for p in Path(tmp).iterdir())
        t0 = time.perf_counter()
        replay = [(t, np.array(img)) for t, img in Recording(tmp).frames()]
        t_read = 1e3 * (time.perf_counter() - t0)
    if len(replay) != len(frames) or not all(
            np.array_equal(img, f.astype(np.uint8))
            for (_, img), (_, f) in zip(replay, frames)):
        raise AssertionError("record/replay: frames differ after the "
                             "round trip")
    det = Determinator()
    eng = MageSlamTorch(console_torch.fast_settings(), cal, seed=1,
                        determinator=det)
    fast_cuda.reset_launch_counts()
    for t, img in replay:
        eng.process_frame(img, timestamp=t)
    torch.cuda.synchronize()
    launches = fast_cuda.launch_counts()
    # one dataflow entry per channel: the first diverging channel is named
    logs = []
    for d in (live, det):
        log = DataFlowLog()
        for ch in sorted(set(live.streams) | set(det.streams)):
            log.add(DataFlow(ch).output(np.asarray(d.streams.get(ch, []),
                                                   np.uint32)))
        logs.append(log)
    first = logs[0].first_divergence(logs[1])
    if first is not None:
        ch = logs[0].entries[first]["stage"]
        raise AssertionError(
            f"record/replay: determinism streams differ, first at channel "
            f"{ch!r} (checkpoint {det.compare(live)[ch]})")
    if launches["fast_detect_and_smooth"] != len(replay):
        raise AssertionError(f"record/replay: launches {launches}")
    print(f"[record/replay] {len(replay)} frames recorded in "
          f"{t_write:.1f} ms ({size / 1e6:.2f} MB), read back in "
          f"{t_read:.1f} ms; the replay's determinism streams equal the "
          f"live drive's on all {len(det.streams)} channels "
          f"({sum(map(len, det.streams.values()))} checkpoints); launches "
          f"{launches}", flush=True)
    return launches


def analysis_phase(torch, np, ring_eng):
    """Point-cloud denoising at the ring map's 8192 point slots on the card
    against the same functions on the CPU; a skeleton key over the ring
    engine; an xray capture of one local-BA window."""
    import json as js
    from mageslam_tpu_torch.mapping import local_ba
    from mageslam_tpu_torch.mapstore import denoising as dn
    from mageslam_tpu_torch.runtime.skeleton_key import craft_skeleton_key
    from mageslam_tpu_torch.solvers.bundle_adjust import bundle_adjust
    from mageslam_tpu_torch.utils.xray import Xray

    m = ring_eng.map_state
    pts, valid, view = m.mp_pos, m.mp_valid, m.mp_normal
    cpu = [x.cpu() for x in (pts, valid, view)]
    idx_g, t_knn = timed(torch, lambda: dn.knn_indices(pts, valid),
                         warm=True)
    idx_c = dn.knn_indices(*cpu[:2])
    ok = valid.cpu()
    if not torch.equal(idx_g.cpu()[ok], idx_c[ok]):
        raise AssertionError("analysis: knn indices differ from the CPU's")
    n_g, t_normals = timed(torch, lambda: dn.estimate_normals(
        pts, valid, view), warm=True)
    n_c = dn.estimate_normals(*cpu)
    # normals are compared where the smallest eigenvalue is separated:
    # there the eigenvector is defined to float32 rounding on any device
    nb = cpu[0][idx_c]
    c = nb - nb.mean(1, keepdim=True)
    lam = torch.linalg.eigvalsh(torch.einsum("nka,nkb->nab", c, c) / 12)
    general = ok & ((lam[:, 1] - lam[:, 0]) >= 1e-3 * lam[:, 2])
    dn_err = float((n_g.cpu() - n_c)[general].abs().max())
    # mollification and repositioning on the same normals on both sides
    mo_g, t_mollify = timed(torch, lambda: dn.mollify_normals(
        pts, n_c.to(pts.device), valid), warm=True)
    mo_c = dn.mollify_normals(cpu[0], n_c, cpu[1])
    mo_err = float((mo_g.cpu() - mo_c)[ok].abs().max())
    rp_g, t_repos = timed(torch, lambda: dn.reposition_points(
        pts, mo_c.to(pts.device), valid), warm=True)
    rp_c = dn.reposition_points(cpu[0], mo_c, cpu[1])
    # relative to the coordinates' size (metres; float32 sums of 12
    # weighted terms in another order on the card)
    rp_err = float(((rp_g.cpu() - rp_c).abs()
                    / rp_c.abs().clamp(min=1.0)).max())
    if not (dn_err <= 1e-3 and mo_err <= 1e-5 and rp_err <= 1e-5
            and int(general.sum()) >= 0.5 * int(ok.sum())):
        raise AssertionError(
            f"analysis: denoising off the CPU's: normals {dn_err} on "
            f"{int(general.sum())} of {int(ok.sum())} points, mollified "
            f"{mo_err}, repositioned {rp_err}")
    key = craft_skeleton_key(ring_eng)
    snap, t_snap = timed(torch, key.snapshot)
    fids, traj = key.get_trajectory()
    if snap["num_keyframes"] != ring_eng.num_keyframes \
            or snap["num_map_points"] != ring_eng.num_map_points \
            or len(snap["map_points"]) != ring_eng.num_map_points \
            or not len(fids) or not np.isfinite(traj).all():
        raise AssertionError(f"analysis: skeleton key snapshot "
                             f"{snap['num_keyframes']} keyframes / "
                             f"{snap['num_map_points']} points against the "
                             f"engine's {ring_eng.num_keyframes} / "
                             f"{ring_eng.num_map_points}")
    s = ring_eng.settings
    cap, px = s.capacity, 1.0 / float(ring_eng.cal.fx)
    last = int(m.kf_frame_id.masked_fill(~m.kf_valid, -1).argmax())
    win = local_ba.build_local_window(m, last, 15,
                                      window_size=cap.local_ba_keyframes,
                                      num_fixed=8,
                                      max_points=cap.local_ba_points)
    res = bundle_adjust(win.problem, s.bundle_adjust.huber_width * px,
                        s.bundle_adjust.max_outlier_error * px,
                        num_steps=8, pose_tethers=False)
    xr = Xray()
    _, t_xray = timed(torch, lambda: xr.capture("local_ba", win, res))
    size = len(js.dumps(xr.records))
    print(f"[analysis] denoising at {pts.shape[0]} point slots "
          f"({int(ok.sum())} valid) on the card: knn {t_knn:.1f} ms (indices "
          f"equal to the CPU's), estimate_normals {t_normals:.1f} ms (max "
          f"|dn| {dn_err:.2e} on the {int(general.sum())} points in general "
          f"position), mollify_normals {t_mollify:.1f} ms (max {mo_err:.2e}"
          f"), reposition_points {t_repos:.1f} ms (max {rp_err:.2e} of the "
          f"coordinate); "
          f"skeleton key snapshot {t_snap:.1f} ms ({snap['num_keyframes']} "
          f"keyframes, {snap['num_map_points']} points, trajectory "
          f"{len(fids)} poses); xray of a local-BA window "
          f"({int(win.kf_list_valid.sum())} keyframes, "
          f"{int(win.mp_list_valid.sum())} points) {t_xray:.1f} ms, "
          f"{size / 1e3:.1f} kB of JSON", flush=True)


def _max_diffs(np, poses, points, want_poses, want_points, v, mv):
    """Max |difference| of the live keyframe poses and map points."""
    return (float(np.abs(np.asarray(poses)[v] - want_poses[v]).max()),
            float(np.abs(np.asarray(points)[mv] - want_points[mv]).max()))


def _perturbed(torch, np, prob, seed, pose_noise, point_noise,
               dtype=None):
    """``prob`` with its free keyframe poses retracted and its live points
    moved by seeded normal noise, in ``dtype`` (default float32)."""
    from mageslam_tpu_torch.geometry import se3
    g = np.random.default_rng(seed)
    K, L = prob.kf_poses.shape[0], prob.points.shape[0]
    dev = prob.kf_poses.device
    xi = torch.as_tensor(g.normal(0, pose_noise, (K, 6)),
                         dtype=torch.float32, device=dev)
    dx = torch.as_tensor(g.normal(0, point_noise, (L, 3)),
                         dtype=torch.float32, device=dev)
    p = prob._replace(
        kf_poses=torch.where(prob.kf_fixed[:, None], prob.kf_poses,
                             se3.pose_retract(prob.kf_poses, xi)),
        points=torch.where(prob.point_valid[:, None], prob.points + dx,
                           prob.points))
    dtype = dtype or torch.float32
    return p._replace(**{f: v.to(dtype) for f, v in p._asdict().items()
                         if v.dtype == torch.float32})


def _moved(prob, res):
    """How far a solve moved the free keyframe poses and the live points
    from ``prob``'s start (max |difference|)."""
    return (float((res.kf_poses - prob.kf_poses)[~prob.kf_fixed]
                  .abs().max()),
            float((res.points - prob.points)[prob.point_valid].abs().max()))


def parallel_phase(torch, np, ring_eng, z):
    """The parallel layer on the card: (a) distributed BA, (b) trajectory
    sharding, (c) the multi-process certification, (d) the session fleet
    at full width.  Returns the fleet drive's kernel launches."""
    import dataclasses
    from mageslam_tpu_torch import MageSlamSettings, convert
    from mageslam_tpu_torch.io.synthetic import (FLEET_SEED, fleet_frames,
                                                 frame_crcs)
    from mageslam_tpu_torch.mapping import global_ba
    from mageslam_tpu_torch.mapstore.map_state import MapState
    from mageslam_tpu_torch.ops import fast_cuda
    from mageslam_tpu_torch.parallel import distributed_ba as dba
    from mageslam_tpu_torch.parallel import multiprocess as mp
    from mageslam_tpu_torch.parallel import trajectory_sharding as ts
    from mageslam_tpu_torch.parallel.fleet import SlamFleet, stream_seed
    from mageslam_tpu_torch.runtime import device_engine as de
    from mageslam_tpu_torch.solvers.bundle_adjust import bundle_adjust

    tol = {k[4:]: float(z[k]) for k in z.files if k.startswith("tol/")}
    mesh = dba.make_mesh(devices=["cuda:0"] * 8)

    def close_ba(a, b, what, atol=(1e-4, 1e-3, 1e-3)):
        dp = float((a.kf_poses - b.kf_poses).abs().max())
        dx = float((a.points - b.points).abs().max())
        rel = abs(float(a.mean_sq_error) / float(b.mean_sq_error) - 1.0)
        if not (dp <= atol[0] and dx <= atol[1] and rel <= atol[2]):
            raise AssertionError(f"parallel: {what}: poses {dp}, points "
                                 f"{dx}, MSE relative {rel}")
        return f"poses {dp:.2e}, points {dx:.2e}, MSE rel {rel:.2e}"

    def moved_well(prob, res, what):
        # a comparison means something only if the solve moved the map by
        # well over its tolerance: ten times the float32 one
        mp_, mx = _moved(prob, res)
        if not (mp_ >= 1e-3 and mx >= 1e-2):
            raise AssertionError(f"parallel: {what}: single-device BA moved "
                                 f"poses {mp_}, points {mx} only")
        return f"moved poses {mp_:.2e}, points {mx:.2e}"

    # (a) distributed BA: the certification problem and the ring's map
    cert, t_cert = timed(torch, lambda: mp.run_certification(mesh),
                         warm=True)
    for kind in ("standalone", "engine"):
        for q, t in (("poses", "cert_poses"), ("points", "cert_points")):
            d = float(np.abs(cert[f"{kind}_{q}"]
                             - z[f"cert_{kind}_{q}"]).max())
            if not d <= tol[t]:
                raise AssertionError(f"parallel: certification {kind} {q} "
                                     f"{d} from JAX's (tolerance {tol[t]})")
        rel = abs(float(cert[f"{kind}_mse"])
                  / float(z[f"cert_{kind}_mse"]) - 1.0)
        if not (rel <= tol["cert_mse_rel"]
                and float(cert[f"{kind}_mse"]) < 1e-6):
            raise AssertionError(f"parallel: certification {kind} MSE "
                                 f"{float(cert[f'{kind}_mse'])}")
    # the certification map starts near its solution: perturb it first
    m_cert, s_cert = mp.certification_map(device="cuda:0")
    prob = _perturbed(torch, np, global_ba.build_global_problem(m_cert)
                      .problem, 11, 0.03, 0.05)
    cert_single = bundle_adjust(prob, 0.01, 0.02, num_steps=6)
    cert_dist = dba.distributed_bundle_adjust(
        dba.shard_problem(prob, mesh), 0.01, 0.02, mesh, num_steps=6)
    cert_err = (close_ba(cert_dist, cert_single, "certification") + ", "
                + moved_well(prob, cert_single, "certification"))

    m = ring_eng.map_state
    s = ring_eng.settings
    fx = float(ring_eng.cal.fx)
    px = 1.0 / fx
    hd = float(np.float32(s.bundle_adjust.huber_width * px))
    moe = float(np.float32(s.graph_optimization.max_outlier_error * px))
    rprob = global_ba.build_global_problem(m).problem
    r_single, t_single = timed(torch, lambda: bundle_adjust(
        rprob, hd, moe, num_steps=6), warm=True)
    rsp = dba.shard_problem(rprob, mesh)
    r_dist, t_dist = timed(torch, lambda: dba.distributed_bundle_adjust(
        rsp, hd, moe, mesh, num_steps=6), warm=True)
    ring_err = close_ba(r_dist, r_single, "ring map")
    ring_mv = _moved(rprob, r_single)
    # float32 sums in another order differ by the map's conditioning; in
    # float64 the two solves of the perturbed map agree to rounding, so a
    # dropped shard or a tether counted twice would show
    rp64 = _perturbed(torch, np, rprob, 11, 0.03, 0.05, torch.float64)
    r64_single = bundle_adjust(rp64, hd, moe, num_steps=6)
    r64_dist = dba.distributed_bundle_adjust(
        dba.shard_problem(rp64, mesh), hd, moe, mesh, num_steps=6)
    ring64_err = (close_ba(r64_dist, r64_single, "ring map in float64",
                           atol=(1e-7, 1e-7, 1e-9)) + ", "
                  + moved_well(rp64, r64_single, "ring map in float64"))
    s_on = s.replace(parallel=dataclasses.replace(
        s.parallel, use_distributed_global_ba=True))
    engine_ba = global_ba.engine_global_bundle_adjust
    (m_on, _), t_eng = timed(torch, lambda: engine_ba(
        m, s_on, fx, num_steps=6, lam0=1e-4, mesh=mesh), warm=True)
    (m_off, _), t_eng1 = timed(torch, lambda: engine_ba(
        m, s, fx, num_steps=6, lam0=1e-4), warm=True)
    v, mv = m.kf_valid.cpu().numpy(), m.mp_valid.cpu().numpy()
    dp, dx = _max_diffs(np, m_on.kf_pose.cpu(), m_on.mp_pos.cpu(),
                        m_off.kf_pose.cpu().numpy(),
                        m_off.mp_pos.cpu().numpy(), v, mv)
    if not (dp <= 1e-4 and dx <= 1e-3):
        raise AssertionError(f"parallel: engine-routed distributed BA off "
                             f"single-device: poses {dp}, points {dx}")
    print(f"[parallel a] distributed BA on 8 shards of cuda:0: "
          f"certification perturbed against the card's single-device BA "
          f"{cert_err}, "
          f"against JAX's stored certification within the fixture's "
          f"tolerances (MSE {float(cert['standalone_mse']):.4e}), "
          f"run_certification {t_cert:.1f} ms; ring map ({m.kf_pose.shape[0]}"
          f" keyframe slots, {m.mp_pos.shape[0]} point slots, "
          f"{int(v.sum())} / {int(mv.sum())} live): {ring_err} (single-"
          f"device moved poses {ring_mv[0]:.2e}, points {ring_mv[1]:.2e}); "
          f"perturbed in float64: {ring64_err}; 6 LM steps "
          f"{t_dist:.1f} ms distributed against {t_single:.1f} ms "
          f"single-device; engine_global_bundle_adjust distributed "
          f"{t_eng:.1f} ms against single {t_eng1:.1f} ms (poses {dp:.2e}, "
          f"points {dx:.2e})", flush=True)

    # (b) trajectory sharding: the JAX engine's stored ring map, then the
    # ring drive's final map
    jm = convert.map_from_npz(z, device="cuda:0")
    js = MageSlamSettings.from_json(str(z["map_settings_json"]))
    jfx = float(z["map_cal"][0])
    for h, kw in ((2, dict(min_covis=100000)), (1, dict(min_covis=1))):
        plan, teth, perm = ts.plan_from_map(jm, 8, halo=h, **kw)
        p = f"plan{h}_"
        got = {f: getattr(plan, f) for f in ("land_perm", "block_start",
                                             "n_dropped_obs",
                                             "n_dropped_points")}
        got.update({f"problem/{f}": getattr(plan.problem, f) for f in
                    ("point_valid", "obs_kf", "obs_valid", "kf_fixed")})
        got.update({f"tethers/{f}": getattr(teth, f) for f in
                    ("i", "j", "ttype", "n_pairs")})
        got["perm"] = perm
        for k, t in got.items():
            if not np.array_equal(t.cpu().numpy(), z[p + k]):
                raise AssertionError(f"parallel: plan halo {h}: {k} "
                                     "differs from JAX's")
    s2 = js.replace(parallel=dataclasses.replace(
        js.parallel, trajectory_halo=2, trajectory_max_tethers=32,
        trajectory_tether_min_covis=5))
    (jm2, jres, info), t_ts = timed(
        torch, lambda: ts.trajectory_sharded_global_ba(jm, s2, jfx, mesh,
                                                       num_steps=6),
        warm=True)
    jv, jmv = z["map/kf_valid"], z["map/mp_valid"]
    dp, dx = _max_diffs(np, jm2.kf_pose.cpu(), jm2.mp_pos.cpu(),
                        z["ts_kf_pose"], z["ts_mp_pos"], jv, jmv)
    ok = dp <= tol["ts_poses"] and dx <= tol["ts_points"]
    jmse = float(jres.mean_sq_error)
    rel = abs(jmse / float(z["ts_mse"]) - 1.0)
    (_, j1), _ = timed(torch, lambda: global_ba.global_bundle_adjust(
        jm, float(np.float32(js.bundle_adjust.huber_width / jfx)),
        float(np.float32(js.graph_optimization.max_outlier_error / jfx)),
        num_steps=6))
    if not (ok and rel <= tol["ts_mse_rel"]
            and jmse <= 3.0 * float(j1.mean_sq_error) + 1e-9):
        raise AssertionError(f"parallel: trajectory-sharded BA on the JAX "
                             f"map: poses {dp}, points {dx} from JAX's, MSE "
                             f"{jmse} (JAX {float(z['ts_mse'])}, single "
                             f"{float(j1.mean_sq_error)})")
    ts_jax = (f"JAX's stored ring map ({int(jv.sum())} keyframes): plans at "
              f"halo 2 and 1 equal JAX's, sharded solve {t_ts:.1f} ms, "
              f"info {info}, MSE {jmse:.4e} (JAX {float(z['ts_mse']):.4e}, "
              f"single {float(j1.mean_sq_error):.4e}), poses {dp:.2e}, "
              f"points {dx:.2e} from JAX's")
    m_cpu = MapState(*[x.cpu() for x in m])
    plan_g, teth_g, perm_g = ts.plan_from_map(m, 8, halo=2, max_tethers=32,
                                              min_covis=5)
    plan_c, teth_c, perm_c = ts.plan_from_map(m_cpu, 8, halo=2,
                                              max_tethers=32, min_covis=5)
    pairs = [(plan_g.land_perm, plan_c.land_perm),
             (plan_g.block_start, plan_c.block_start),
             (plan_g.n_dropped_obs, plan_c.n_dropped_obs),
             (plan_g.problem.obs_kf, plan_c.problem.obs_kf),
             (plan_g.problem.obs_valid, plan_c.problem.obs_valid),
             (teth_g.i, teth_c.i), (teth_g.j, teth_c.j),
             (teth_g.weight, teth_c.weight), (perm_g, perm_c)]
    if not all(torch.equal(a.cpu(), b) for a, b in pairs):
        raise AssertionError("parallel: the ring map's plan on the card "
                             "differs from the CPU's")
    s3 = s.replace(parallel=dataclasses.replace(
        s.parallel, trajectory_halo=2, trajectory_max_tethers=32,
        trajectory_tether_min_covis=5))
    (_, rres, rinfo), t_rts = timed(
        torch, lambda: ts.trajectory_sharded_global_ba(m, s3, fx, mesh,
                                                       num_steps=6),
        warm=True)
    rmse = float(rres.mean_sq_error)
    if not (np.isfinite(rmse)
            and rmse <= 3.0 * float(r_single.mean_sq_error) + 1e-9):
        raise AssertionError(f"parallel: trajectory-sharded BA on the ring "
                             f"map: MSE {rmse} against single "
                             f"{float(r_single.mean_sq_error)}")
    print(f"[parallel b] trajectory sharding on 8 shards of cuda:0: "
          f"{ts_jax}; the ring drive's map: plan equal to the CPU's, "
          f"sharded solve {t_rts:.1f} ms, info {rinfo}, MSE {rmse:.4e} "
          f"(single-device {float(r_single.mean_sq_error):.4e})", flush=True)

    # (c) two processes over gloo, four shards each on the card
    t0 = time.perf_counter()
    results, logs = mp.spawn_certification(2, 4, timeout=300.0)
    t_spawn = time.perf_counter() - t0
    for key in mp.RESULT_KEYS + ("standalone_mse", "engine_mse"):
        if not np.array_equal(results[0][key], cert[key]):
            raise AssertionError(f"parallel: 2-process {key} differs from "
                                 "the in-process 8-shard run on the card")
    if not all("global=8 processes=2" in log for log in logs):
        raise AssertionError(f"parallel: workers did not join: {logs}")
    print(f"[parallel c] spawn_certification(2, 4) on cuda:0 over gloo: "
          f"ranks bit-identical to each other and to the in-process run, "
          f"standalone MSE {float(results[0]['standalone_mse']):.4e}, engine "
          f"MSE {float(results[0]['engine_mse']):.4e}, {t_spawn:.1f} s",
          flush=True)

    # (d) eight sessions on the card at full width, 30 frames each
    n, nf = 8, 30
    imgs, cal = fleet_frames(n, nf)
    if not np.array_equal(frame_crcs(imgs), z["fleet8_crc"]):
        raise AssertionError("parallel: fleet frames differ from JAX's")
    fs = MageSlamSettings.from_json(str(z["fleet8_settings_json"]))
    fleet = SlamFleet(fs, cal, mesh=["cuda:0"] * n, seed=FLEET_SEED)
    fast_cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in range(nf):
        fleet.process_frames(imgs[f], timestamps=np.full(n, f / 30.0))
    res = fleet.flush()
    torch.cuda.synchronize()
    t_fleet = time.perf_counter() - t0
    launches = fast_cuda.launch_counts()
    if launches["fast_detect_and_smooth"] != n * nf:
        raise AssertionError(f"parallel: fleet launches {launches}")
    rows = np.stack([res[f] for f in range(nf)], 1)
    tracked = (rows[..., 0] == de.CODE_TRACKING).sum(1)
    jtracked = (z["fleet8_rows"][..., 0] == de.CODE_TRACKING).sum(1)
    if (tracked < jtracked - tol["fleet_tracked"]).any():
        raise AssertionError(f"parallel: fleet tracked {tracked} against "
                             f"JAX {jtracked}")
    eng = de.DeviceEngine(fs, cal, "cuda:0", seed=stream_seed(FLEET_SEED, 0))
    st = eng.empty_state()
    solo_frames = torch.as_tensor(imgs[:, 0]).cuda()
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in range(nf):
        st, out = eng.step(st, solo_frames[f], float(np.float32(f / 30.0)),
                           f)
        outs.append(out)
    torch.cuda.synchronize()
    t_solo = time.perf_counter() - t0
    for f, out in enumerate(outs):
        if not np.array_equal(out.cpu().numpy(), rows[0, f]):
            raise AssertionError(f"parallel: fleet stream 0 differs from "
                                 f"the solo engine at frame {f}")
    print(f"[parallel d] fleet of {n} sessions on cuda:0 at "
          f"{fs.capacity.max_features} feature slots, "
          f"{fs.capacity.max_keyframes} keyframes, "
          f"{fs.capacity.max_map_points} points, {nf} frames: tracked "
          f"{tracked.tolist()} (JAX fleet {jtracked.tolist()}), stream 0 "
          f"equal to a solo engine in every slot, {n * nf / t_fleet:.2f} "
          f"frames/s in all, {nf / t_fleet:.2f} frames/s per stream, "
          f"{t_fleet:.1f} s (the solo engine on stream 0's frames: "
          f"{nf / t_solo:.2f} frames/s), launches {launches}", flush=True)
    return launches


def long_frames(np, z):
    """The long session's frames, rendered on the host by the port's copy
    of the synthetic world, each checked against the JAX renderer's CRC-32
    (the fixture carries the frames it cannot reproduce)."""
    import zlib
    from mageslam_tpu_torch.io import synthetic
    world = synthetic.SyntheticWorld.create_ring(900, seed=5)
    cal = synthetic.default_calibration()
    poses = synthetic.loop_trajectory(len(z["crcs"]), radius=LONG_RADIUS,
                                      fraction=LONG_FRACTION)
    if not np.allclose(poses, z["gt_poses"], atol=1e-6):
        raise AssertionError("long session: trajectory differs from the "
                             "fixture's")
    fix = dict(zip(z["fix_idx"].tolist(), z["fix_frames"]))
    imgs = []
    for i, pose in enumerate(poses):
        if i in fix:
            imgs.append(fix[i])
            continue
        img = world.render(cal, pose, seed=100 + i)
        if zlib.crc32(np.ascontiguousarray(img).tobytes()) \
                != int(z["crcs"][i]):
            raise AssertionError(f"long session: frame {i} differs from the "
                                 "JAX renderer's")
        imgs.append(img)
    return imgs


def long_drive(eng, frames, n: int, at: int, resume=None):
    """Frames 0 to ``n`` - 1 of ``frames`` through the facade ``eng``,
    flushed after frame ``at`` (the initialization); with ``resume``, the
    engine's state is replaced there by ``resume``.  Returns the output
    rows (n, 24), the clock after each frame and a copy of the engine's
    own state after frame ``at`` (the step writes into some of its
    state's tensors)."""
    import numpy as np
    from bench_torch import clone_state
    stamps, own = [], None
    for i in range(n):
        eng.process_frame(frames[i], timestamp=i / 30.0)
        stamps.append(time.perf_counter())
        if i == at:
            eng.flush()
            own = clone_state(eng.state)
            if resume is not None:
                eng.state = resume
    eng.flush()
    return np.stack([eng.output_row(i) for i in range(n)]), stamps, own


def init_reference(np, st, z) -> str:
    """Which stored initial map the engine state ``st`` holds: ``jax``
    (``init_post/``, the JAX engine's) or ``card`` (``card_init/``, the
    port's own on the card); raises if neither, within 1e-3 in the
    keyframe poses."""
    valid = st.map.kf_valid.cpu().numpy()
    pose = st.map.kf_pose.cpu().numpy()
    gaps = {}
    for ref, prefix in (("jax", "init_post/"), ("card", "card_init/")):
        want = z.get(prefix + "map/kf_pose", z["init_post/map/kf_pose"])
        if np.array_equal(valid, z["init_post/map/kf_valid"]):
            gaps[ref] = float(np.abs(pose[valid] - want[valid]).max())
            if gaps[ref] <= 1e-3:
                return ref
    raise AssertionError(f"long session: the initial map matches no stored "
                         f"one (keyframe pose gaps {gaps}, slots "
                         f"{np.nonzero(valid)[0].tolist()})")


def long_outcome(np, eng, rows, z) -> dict:
    """A long drive's outcome, as ``tests/test_long_session.py`` reads it,
    and its fossil's Sim3 ATE."""
    from mageslam_tpu_torch.io.evaluation import ate_rmse
    from mageslam_tpu_torch.runtime import device_engine as de
    st = eng.state
    tracking = rows[:, 0].astype(int) == de.CODE_TRACKING
    fossil = eng.fossilize()
    if not np.isfinite(fossil.poses).all():
        raise AssertionError("long session: non-finite fossil pose")
    est, ref = [], []
    for i in range(len(rows)):
        p = fossil.pose_for_frame(i)
        if tracking[i] and p is not None:
            est.append(p)
            ref.append(z["gt_poses"][i])
    ate, _, gt_c = ate_rmse(np.asarray(est), np.asarray(ref))
    alive = rows[:, 9].astype(int)
    return {"tracked": int(tracking.sum()),
            "last50": int(tracking[-50:].sum()),
            "first_lost": first_lost(np, rows[:, 0], int(z["init_frame"])),
            "ever": int(st.map.num_kf_ever), "alive": int(alive[-1]),
            "alive_max": int(alive.max()),
            "shapes": (st.map.kf_valid.shape[0], st.map.mp_valid.shape[0],
                       st.history.valid.shape[0]),
            "history": int(st.history.valid.sum()),
            "points": eng.num_map_points, "loops": eng.loops_closed,
            "ate": float(ate),
            "extent": float(np.linalg.norm(gt_c.max(0) - gt_c.min(0)))}


def first_lost(np, codes, at: int) -> int:
    """The first frame after the initialization frame ``at`` that is not
    tracked (-1: none)."""
    from mageslam_tpu_torch.runtime import device_engine as de
    lost = (np.asarray(codes).astype(int) != de.CODE_TRACKING) \
        & (np.arange(len(codes)) > at)
    return int(np.argmax(lost)) if lost.any() else -1


def long_bounds(z, ref: str, cap) -> dict:
    """The bounds a long drive from initial map ``ref`` is held to: the
    JAX engine's drives from the same map."""
    if ref == "jax":
        return {"tracked": min(int(z[f"s{s}_tracked"]) for s in (1, 2, 3))
                - 32, "last50": 40, "history": 600, "ate": float(
                    z["ate_bound"]), "ever_over_capacity": True}
    return {"tracked": int(z["ci_tracked"]) - 32,
            "last50": int(z["ci_last50"]) - 10,
            "history": int(z["ci_history_valid"]) - 32,
            "ate": 1.5 * float(z["ci_ate"]),
            "ever_over_capacity": int(z["ci_kf"][-1, 0]) > cap.max_keyframes}


def check_long(o: dict, bounds: dict, cap, label: str) -> None:
    shapes = (cap.max_keyframes, cap.max_map_points, cap.pose_history_size)
    faults = []
    if o["tracked"] < bounds["tracked"] or o["last50"] < bounds["last50"]:
        faults.append(f"tracked {o['tracked']}, last 50 frames {o['last50']}")
    if o["alive_max"] > cap.max_keyframes:
        faults.append(f"keyframes alive up to {o['alive_max']}")
    if bounds["ever_over_capacity"] and o["ever"] <= cap.max_keyframes:
        faults.append(f"{o['ever']} keyframes ever")
    if o["shapes"] != shapes:
        faults.append(f"shapes {o['shapes']}")
    if o["history"] < bounds["history"]:
        faults.append(f"{o['history']} history entries")
    if not o["ate"] < bounds["ate"]:
        faults.append(f"ATE {o['ate']}")
    if faults:
        raise AssertionError(f"long session ({label}): {'; '.join(faults)} "
                             f"(bounds {bounds})")


def long_session_phase(torch, np, z):
    """``tests/test_long_session.py``'s drive on the card: 640 frames of a
    slow double loop with 40 keyframe slots, twice: (a) from the port's own
    initialization, held to the JAX engine's drive from the same initial
    map, and (b) resumed from the JAX engine's state after its
    initialization, so that keyframe creation runs past capacity (force
    cull, slot recycling, history re-anchoring, fossilize over a churned
    map), held to the JAX engine's drives at seeds 1-3
    (``tests/data/torch_long640.npz``)."""
    from mageslam_tpu_torch import MageSlamSettings, convert
    from mageslam_tpu_torch.ops import fast, fast_cuda

    t0 = time.perf_counter()
    imgs = long_frames(np, z)
    render_s = time.perf_counter() - t0
    n = len(imgs)
    settings = MageSlamSettings.from_json(str(z["settings_json"]))
    cap = settings.capacity
    k = int(z["init_frame"])
    launches = {}
    for label in ("own", "resumed"):
        eng, _ = make_engine(settings, z)
        resume = None if label == "own" else convert.engine_state_from_npz(
            z, "init_post/", device=eng.device)
        fast_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        rows, stamps, own = long_drive(eng, imgs, n, k, resume)
        syncs = eng.host_syncs
        o = long_outcome(np, eng, rows, z)
        torch.cuda.synchronize()
        t_total = time.perf_counter() - t0
        counts = fast_cuda.launch_counts()
        if counts["fast_detect_and_smooth"] != n:
            raise AssertionError(f"long session ({label}): launches "
                                 f"{counts} for {n} frames")
        for name in counts:
            launches[name] = launches.get(name, 0) + counts[name]
        ref = init_reference(np, own, z) if resume is None else "jax"
        bounds = long_bounds(z, ref, cap)
        alive = rows[:, 9].astype(int)
        full = int(np.argmax(alive >= cap.max_keyframes)) \
            if alive.max() >= cap.max_keyframes else -1
        jfull = int(np.argmax(z["s1_kf"][:, 1] >= cap.max_keyframes))
        steady = (n - 21) / (stamps[-1] - stamps[19])
        if ref == "jax":
            seeds = (1, 2, 3)
            jax_line = (
                f"JAX seeds 1-3 tracked "
                f"{[int(z[f's{s}_tracked']) for s in seeds]}, first lost at "
                f"{[first_lost(np, z[f's{s}_codes'], k) for s in seeds]}, "
                f"keyframes ever {int(z['s1_kf'][-1, 0])} (seed 1), "
                f"capacity first at frame {jfull} (seed 1), ATE "
                f"{[round(float(z[f's{s}_ate']), 5) for s in seeds]}")
        else:
            jax_line = (
                f"JAX from this map tracked {int(z['ci_tracked'])}, first "
                f"lost at {first_lost(np, z['ci_codes'], k)}, last 50 "
                f"{int(z['ci_last50'])}, keyframes ever "
                f"{int(z['ci_kf'][-1, 0])}, ATE {float(z['ci_ate']):.5f}")
        print(f"[long {label}] initial map: "
              f"{'resumed from JAX' if resume is not None else ref}'s; "
              f"tracked {o['tracked']}/{n}, first lost at frame "
              f"{o['first_lost']}, last 50 frames {o['last50']}; "
              f"keyframes ever {o['ever']}, alive {o['alive']} (at most "
              f"{o['alive_max']} at any frame), capacity first at frame "
              f"{full}; map points {o['points']}, history entries "
              f"{o['history']}, loops closed {o['loops']}; ATE "
              f"{o['ate']:.5f} on an extent of {o['extent']:.3f}; "
              f"({jax_line}; bounds {bounds})", flush=True)
        print(f"[long {label}] steady frames/s over frames 20-{n - 1} "
              f"{steady:.2f}, host syncs/frame {syncs / n:.2f} (+1 read per "
              f"window of 8 output rows), drive+fossilize {t_total:.1f} s; "
              f"launches {counts}", flush=True)
        check_long(o, bounds, cap, label)
    # the kernel against its plain version on this drive's frames
    for i in LONG_CHECK_FRAMES:
        img = torch.as_tensor(imgs[i]).cuda()
        _, err = check_against_plain(torch, fast, fast_cuda, img, 7,
                                     f"long session frame {i}")
        if err != 0.0:
            raise AssertionError(f"long session frame {i}: blur error {err}")
    print(f"[long] {n} frames rendered and checked against the JAX "
          f"renderer's CRCs in {render_s:.1f} s; kernel exact against plain "
          f"on frames {list(LONG_CHECK_FRAMES)}", flush=True)
    print(run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]), flush=True)
    return launches


def run_tool(args, tag: str, timeout: float = 600) -> str:
    """Run a tool of the repo in a fresh process; its output, printed
    under ``tag``.  Raises if it fails."""
    proc = subprocess.run([sys.executable, *map(str, args)],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=str(ROOT))
    if proc.returncode != 0:
        raise AssertionError(f"{tag}: rc {proc.returncode}\n{proc.stdout}"
                             f"\n{proc.stderr[-3000:]}")
    for line in proc.stdout.strip().splitlines():
        print(f"[{tag}] {line}", flush=True)
    return proc.stdout


def check_init_outcome(np, codes, want, label: str, first_slack: int = 5,
                       tracked_slack: int = 5, warmup: int = 50):
    """The drive initializes if and only if JAX's did (its first tracking
    frame within ``first_slack`` of JAX's) and tracks at least JAX's count
    of timed frames minus ``tracked_slack``."""
    init, jinit = bool((codes == 2).any()), bool((want == 2).any())
    first = int(np.argmax(codes == 2)) if init else -1
    jfirst = int(np.argmax(want == 2)) if jinit else -1
    tracked = int((codes[warmup:] == 2).sum())
    jtracked = int((want[warmup:] == 2).sum())
    if init != jinit or abs(first - jfirst) > first_slack:
        raise AssertionError(f"{label}: first tracking frame {first}, JAX's "
                             f"{jfirst} (-1: never initialized)")
    if tracked < jtracked - tracked_slack:
        raise AssertionError(f"{label}: tracked {tracked} < JAX {jtracked} "
                             f"- {tracked_slack}")
    return first, jfirst, tracked, jtracked


def check_init_spread(np, firsts, want, frames: int, slack: int = 3):
    """Over the same seeds, the median first tracking frame (a drive that
    never tracks counts as ``frames``) within ``slack`` frames of JAX's."""
    med = float(np.median(np.where(firsts < 0, frames, firsts)))
    jmed = float(np.median(np.where(want < 0, frames, want)))
    if abs(med - jmed) > slack:
        raise AssertionError(f"init seeds: first tracking frames "
                             f"{firsts.tolist()} (median {med}), JAX's "
                             f"{want.tolist()} (median {jmed})")
    return med, jmed


def bench_phase(torch, np, b):
    """``bench_torch.py``, the port's example and its tools: the kernel table
    and the device step in fresh processes; one bench drive at
    ``ref_settings()`` and one at ``fast_settings()`` held to the JAX
    engine's codes (``tests/data/torch_bench.npz``), and the first
    tracking frame over 12 seeds held to JAX's; ``run_synthetic_torch`` at its
    defaults held to JAX's ``run_synthetic``; the matching, scaling,
    frontend-profile and feed tools at small sizes; the dataset tool (or
    its ``ImportError`` where matplotlib is missing)."""
    import tempfile
    sys.path.insert(0, str(ROOT / "examples"))
    import bench_torch
    import console_torch
    import run_synthetic_torch
    from mageslam_tpu_torch.ops import fast_cuda

    table = bench_torch.sub_record("--kernel-table", "KERNEL_TABLE", 600)
    print(f"[bench] kernel table (ms per call, host clock; events in "
          f"event_ms): {json.dumps(table)}", flush=True)
    step = bench_torch.sub_record("--device-step", "DEVICE_STEP", 600)
    print(f"[bench] device step: {json.dumps(step)}", flush=True)
    if not step["restep_equal"]:
        raise AssertionError("device step: two steps from clones of one "
                             "state differ")

    t0 = time.perf_counter()
    imgs = bench_torch.bench_frames()
    crcs = bench_torch.frame_crcs(imgs)
    if not np.array_equal(crcs, b["bench_crcs"]):
        bad = int((crcs != b["bench_crcs"]).sum())
        raise AssertionError(f"bench frames: {bad} differ from the JAX "
                             "renderer's")
    render_s = time.perf_counter() - t0
    # at ref_settings() neither engine initializes: a parity record, cut
    # to its first frames to keep the script's time
    eng = bench_torch.make_engine(bench_torch.ref_settings())
    fast_cuda.reset_launch_counts()
    d = bench_torch.bench_drive(eng, imgs[:REF_BENCH_FRAMES])
    torch.cuda.synchronize()
    launches = fast_cuda.launch_counts()
    if launches["fast_detect_and_smooth"] != REF_BENCH_FRAMES:
        raise AssertionError(f"bench drive: launches {launches} for "
                             f"{REF_BENCH_FRAMES} frames")
    first, jfirst, tracked, jtracked = check_init_outcome(
        np, d["codes"], b["bench_ref_codes"][:REF_BENCH_FRAMES],
        "bench drive")
    print(f"[bench] one drive at ref_settings() over the first "
          f"{REF_BENCH_FRAMES} frames, frames rendered and "
          f"checked against the JAX renderer's CRCs in {render_s:.1f} s: "
          f"{d['fps']:.2f} frames/s over the "
          f"{REF_BENCH_FRAMES - bench_torch.WARMUP} timed frames, tracked "
          f"{tracked} (JAX {jtracked}), first tracking frame {first} (JAX "
          f"{jfirst}; -1: never initialized, so the frames/s are those of a "
          f"step without mapping), host syncs/frame "
          f"{d['host_syncs_per_frame']:.2f}, launches {launches}; a parity "
          f"record: neither engine initializes here, so this drive cannot "
          f"catch a port that fails to", flush=True)

    # fast_settings(): JAX's drive initializes, so this one holds the port
    # to initializing; then the first tracking frame over 12 seeds
    eng = bench_torch.make_engine(console_torch.fast_settings())
    fast_cuda.reset_launch_counts()
    d = bench_torch.bench_drive(eng, imgs)
    n_init = bench_torch.INIT_FRAMES
    firsts = bench_torch.first_tracking_frames(eng, imgs[:n_init])
    torch.cuda.synchronize()
    counts = fast_cuda.launch_counts()
    n = len(imgs) + n_init * len(bench_torch.INIT_SEEDS)
    if counts["fast_detect_and_smooth"] != n:
        raise AssertionError(f"bench drive (fast): launches {counts} for "
                             f"{n} frames")
    first, jfirst, tracked, jtracked = check_init_outcome(
        np, d["codes"], b["bench_fast_codes"], "bench drive (fast)")
    if not np.array_equal(b["init_seeds"], bench_torch.INIT_SEEDS):
        raise AssertionError(f"init seeds: fixture {b['init_seeds']}")
    med, jmed = check_init_spread(np, firsts, b["init_first"], n_init)
    print(f"[bench] one drive at fast_settings(): {d['fps']:.2f} frames/s, "
          f"tracked {tracked} (JAX {jtracked}), first tracking frame "
          f"{first} (JAX {jfirst}), host syncs/frame "
          f"{d['host_syncs_per_frame']:.2f}; first tracking frame over "
          f"seeds {list(bench_torch.INIT_SEEDS)} on frames 0-{n_init - 1}: "
          f"{firsts.tolist()} (median {med}), JAX's "
          f"{b['init_first'].tolist()} (median {jmed}); launches {counts}",
          flush=True)
    for name in counts:
        launches[name] += counts[name]

    fast_cuda.reset_launch_counts()
    rs = run_synthetic_torch.run(run_synthetic_torch.parse_args([]))
    torch.cuda.synchronize()
    counts = fast_cuda.launch_counts()
    n = len(rs["codes"])
    if rs["engine"].device.type != "cuda" \
            or counts["fast_detect_and_smooth"] != n:
        raise AssertionError(f"run_synthetic: on {rs['engine'].device}, "
                             f"launches {counts} for {n} frames")
    jt, jate = int(b["rs_tracked"]), float(b["rs_ate"])
    if rs["tracked"] < jt - 3 or rs["ate"] is None \
            or not rs["ate"] < 1.5 * jate:
        raise AssertionError(f"run_synthetic: tracked {rs['tracked']} (JAX "
                             f"{jt}), ATE {rs['ate']} (bound 1.5 x {jate})")
    print(f"[run_synthetic] MageSlamTorch at fast_settings(): tracked "
          f"{rs['tracked']}/{n} (JAX {jt}), ATE {rs['ate']:.5f} (JAX "
          f"{jate:.5f}, bound {1.5 * jate:.5f}), {rs['fps']:.2f} frames/s, "
          f"launches {counts}", flush=True)
    for name in counts:
        launches[name] += counts[name]

    tools = ROOT / "tools"
    run_tool([tools / "bench_torch_matching.py", "--sizes", "512"],
             "matching")
    run_tool([tools / "bench_torch_scaling.py", "--shards", "1", "2",
              "--landmarks", "2048"], "scaling")
    run_tool([tools / "profile_torch_frontend.py"], "frontend profile")
    run_tool([tools / "profile_torch_engine.py", "--phase", "feed"],
             "feed profile")
    from mageslam_tpu_torch.io import real_texture
    try:
        real_texture.load_reference_photo()
    except ImportError as e:
        print(f"[dataset tool] not run: {e}", flush=True)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            run_tool([tools / "make_dataset_torch.py", "--out", tmp,
                      "--frames", "3"], "dataset tool")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    for path in (FIXTURE, RING_FIXTURE, FACADE_FIXTURE, DATASET_FIXTURE,
                 HOST_FIXTURE, PARALLEL_FIXTURE, BENCH_FIXTURE, LONG_FIXTURE,
                 MINI_SEQ, RING_SEQ):
        if not path.exists():
            print(f"chip_smoke: missing {path}", file=sys.stderr)
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
    facade = np.load(FACADE_FIXTURE)
    report, worst_err = kernel_phase(torch, np, z["imgs"], facade)
    ring = np.load(RING_FIXTURE)
    launches = {"fast_detect_and_smooth": engine_phase(torch, np, z),
                "fast_detect": wide_blur_phase(torch, np, z)}
    # each drive counts from 0: the orbit's launches, then the multi-level
    # orbit's, the facade's, the rectified frame's, the ring's, the
    # dataset's, the checkpoint drive's and the host engine's three
    for counts in (multilevel_phase(torch, np, z, facade),
                   facade_phase(torch, np, facade),
                   rectified_phase(torch, np, facade)):
        for name in launches:
            launches[name] += counts[name]
    ring_launches, ring_eng = ring_phase(torch, np, ring)
    launches["fast_detect_and_smooth"] += ring_launches
    closure_phase(torch, np, ring, ring_eng.map_state)
    dataset = np.load(DATASET_FIXTURE)
    for counts in (dataset_phase(torch, np, dataset, ring),
                   checkpoint_phase(torch, np, z, dataset)):
        for name in launches:
            launches[name] += counts[name]
    # the host engine: the console, the orbit at full width, a recording
    # of the console's frames replayed; then the analysis consumers
    host = np.load(HOST_FIXTURE)
    console_counts, live = host_console_phase(torch, np, host)
    for counts in (console_counts,
                   host_full_width_phase(torch, np, z, host),
                   record_replay_phase(torch, np, live)):
        for name in launches:
            launches[name] += counts[name]
    analysis_phase(torch, np, ring_eng)
    # the parallel layer; its fleet drive counts from 0
    with np.load(PARALLEL_FIXTURE) as par:
        counts = parallel_phase(torch, np, ring_eng, par)
    for name in launches:
        launches[name] += counts[name]
    # the long session at keyframe capacity; its drive counts from 0
    with np.load(LONG_FIXTURE) as long_z:
        counts = long_session_phase(torch, np, long_z)
    for name in launches:
        launches[name] += counts[name]
    # the bench, run_synthetic and the tools; the in-process drives count
    # from 0
    with np.load(BENCH_FIXTURE) as b:
        counts = bench_phase(torch, np, b)
    for name in launches:
        launches[name] += counts[name]

    main_case = report["180x320 frame"]   # the main path's shape and data
    pallas = "mageslam_tpu/ops/fast_pallas.py"
    replaces = {"fast_detect_and_smooth": f"{pallas}:108",
                "fast_detect": f"{pallas}:81"}
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
        # the same kernel on the pyramid levels
        "shapes": [{
            "shape": label.split()[0],
            "max_abs_err": report[label]["blur_max_abs_err"]
            if name == "fast_detect_and_smooth" else 0.0,
            "ms": report[label][name]["ms"],
            "plain_ms": report[label][name]["plain_ms"],
            "device_us": report[label][name]["device_us"],
            "floor_us": report[label]["floor_us"],
            "bound_ms": 1e-3 * report[label][name]["bound_us"],
            "bound_us": report[label][name]["bound_us"],
            "bound_by": report[label][name]["bound_by"],
        } for label in LEVEL_CASES],
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
