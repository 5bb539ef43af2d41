"""One run of one cell: set-up, the timed window, the check, the result.

The system under test is ``mageslam_tpu_torch``'s fused facade,
``MageSlamTorchFused.process_frame``: one engine step per frame, frames
fed in a closed loop as the console feeds a recording.  The harness takes
from the program only that entry, its spans (wrappers this file puts
around the calls into each layer), its counters (``host_syncs``,
``counts``, the map's keyframe counters) and its kernel names.

A run: frames made on the device from the seed and copied to pinned host
memory; the session warmed up over the traffic's fixed warm-up frames
(initialization, BoW training, the first local-BA windows); the window,
opened and closed by a device sync; then, with the window closed, the
memory peak read and the program's session freed, the plain reference
run over a sample of what the window produced (``check.py``).
"""

from __future__ import annotations

import gc
import importlib.util
import inspect
import json
import math
import sys
import time
from collections import defaultdict
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SEED_MASK = (1 << 63) - 1
PROFILED_FRAMES = 6       # frames under torch.profiler in a traced run


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_spec(man: dict, name: str) -> dict:
    """The cell ``name`` with its configuration file, traffic and the
    metrics it reports."""
    from slambench import generator
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg = next(c for c in man["configs"] if c["name"] == cell["config"])

    def mine(m):
        return name in m.get("workloads", [name])

    return dict(cell=cell,
                config=json.loads((ROOT / cfg["file"]).read_text()),
                traffic=generator.load_traffic(cell["traffic"]),
                end_to_end=[m for m in man["end_to_end"] if mine(m)],
                per_layer=[m for m in man["per_layer"] if mine(m)])


def load_reader(name: str):
    """The reader of per-layer metric ``name``:
    ``slambench/metrics/<name>.py``'s ``read(ctx)``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"slambench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


class Probe:
    """Wrappers around the program's calls into each layer.

    While ``recording``, it keeps what the timed path produced for the
    check: each frame's features (frontend), each tracking pose
    refinement's inputs and outputs, each local-BA call's window and
    result, and for the frames in ``track_frames`` tracking's matching
    (its candidates' predicted pixels, descriptors and validity, each
    search's matches, both refinements).  These are references to
    tensors the program made (and does not write again), so keeping them
    costs no launch.  With
    ``spans`` on, each layer call is bracketed by device syncs and timed
    on the host clock; with ``annotate`` on, it is labelled for the
    profiler.  ``fault`` breaks the timed path for the harness's own
    tests (``tests/test_slambench_faults.py``)."""

    def __init__(self, torch, fused, fault=None):
        from mageslam_tpu_torch.mapping import culling
        from mageslam_tpu_torch.ops import matching
        from mageslam_tpu_torch.runtime import device_engine as de
        from mageslam_tpu_torch.solvers import pnp
        from mageslam_tpu_torch.tracking import track
        self.torch = torch
        self.cuda = fused.device.type == "cuda"
        self.fault = fault
        self.recording = False
        self.spans_on = False
        self.annotate = False
        self.frame = -1
        self.frontend, self.refine, self.ba, self.tracks = [], [], [], []
        self.track_frames = frozenset()
        self._tf = None
        self._in_track = False
        self.span_s = defaultdict(float)
        self.force_culls = 0
        self._restore = []
        eng = fused.engine
        self._patch(de, "extract_features",
                    self._layer("frontend", self._on_features))
        self._patch(pnp, "refine_pose", self._on_refine)
        self._patch(de, "bundle_adjust_impl", self._on_ba)
        self._patch(track, "track_frame", self._on_track)
        self._patch(matching, "radius_match", self._on_radius_match)
        self._patch(matching, "assign_unique", self._on_assign)
        self._patch(culling, "cull_keyframes", self._on_cull)
        self._patch(eng, "track_branch", self._layer("tracking"))
        self._patch(eng, "advance_mapping", self._layer("mapping"))

    def _patch(self, owner, attr, make):
        """Replace ``owner.attr`` by ``make(original)`` until ``close``."""
        orig = getattr(owner, attr)
        self._restore.append((owner, attr, orig, attr in vars(owner)))
        setattr(owner, attr, make(orig))

    def close(self) -> None:
        for owner, attr, orig, own in reversed(self._restore):
            if own:
                setattr(owner, attr, orig)
            else:
                delattr(owner, attr)
        self._restore.clear()

    def _sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def _layer(self, name, after=None):
        def make(fn):
            def wrapped(*a, **k):
                if self.annotate:
                    with self.torch.profiler.record_function(name):
                        out = fn(*a, **k)
                elif self.spans_on:
                    self._sync()
                    t0 = time.perf_counter()
                    out = fn(*a, **k)
                    self._sync()
                    self.span_s[name] += time.perf_counter() - t0
                else:
                    out = fn(*a, **k)
                return after(out) if after is not None else out
            return wrapped
        return make

    def _on_features(self, feats):
        if self.fault == "features_half":
            v = feats.valid.clone()
            v[::2] = False
            feats = feats._replace(valid=v)
        if self.recording:
            self.frontend.append((self.frame, feats))
        return feats

    def _on_refine(self, fn):
        sig = inspect.signature(fn)

        def wrapped(*a, **k):
            out = fn(*a, **k)
            args = sig.bind(*a, **k)
            args.apply_defaults()
            tracking = args.arguments["pose0"].dim() == 1
            if tracking and self.fault == "pose_altered":
                pose = out.pose.clone()
                pose[4:] += 0.01
                out = out._replace(pose=pose)
            if self.recording and tracking:
                self.refine.append((self.frame, dict(args.arguments), out))
            if self._tf is not None:
                self._tf["refine"].append((dict(args.arguments), out))
            return out
        return wrapped

    def _on_track(self, fn):
        def wrapped(*a, **k):
            keep = self.recording and self.frame in self.track_frames
            self._tf = dict(queries=[], rounds=[], refine=[]) if keep \
                else None
            self._in_track = True
            try:
                out = fn(*a, **k)
                if keep:
                    self.tracks.append((self.frame, self._tf))
            finally:
                self._tf = None
                self._in_track = False
            return out
        return wrapped

    def _on_radius_match(self, fn):
        def wrapped(query_uv, query_desc, query_valid, *a, **k):
            if self._tf is not None:
                self._tf["queries"].append((query_uv, query_desc,
                                            query_valid))
            return fn(query_uv, query_desc, query_valid, *a, **k)
        return wrapped

    def _on_assign(self, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            if self.fault == "matches_half" and self.recording \
                    and self._in_track:
                drop = self.torch.arange(out.shape[0],
                                         device=out.device) % 2 == 1
                out = self.torch.where(drop, self.torch.full_like(out, -1),
                                       out)
            if self._tf is not None:
                self._tf["rounds"].append(out)
            return out
        return wrapped

    def _on_ba(self, fn):
        sig = inspect.signature(fn)

        def wrapped(*a, **k):
            out = fn(*a, **k)
            args = sig.bind(*a, **k)
            args.apply_defaults()
            if self.fault == "ba_unchanged":
                p = args.arguments["problem"]
                out = out._replace(kf_poses=p.kf_poses, points=p.points)
            if self.recording:
                self.ba.append((self.frame, dict(args.arguments), out))
            return out
        return wrapped

    def _on_cull(self, fn):
        def wrapped(*a, **k):
            # the engine's force cull at capacity is the one call that
            # passes the whole slot count as its window
            if self.recording and "window" in k:
                self.force_culls += 1
            return fn(*a, **k)
        return wrapped


class GcLog:
    """Collections of Python's cyclic garbage collector and the seconds
    they took, by generation, from construction to ``close`` (a host
    pause the window pays, read through ``gc.callbacks``)."""

    def __init__(self):
        self.n = [0, 0, 0]
        self.s = [0.0, 0.0, 0.0]
        self._t0 = None
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            g = info["generation"]
            self.n[g] += 1
            self.s[g] += time.perf_counter() - self._t0

    def close(self):
        if self._cb in gc.callbacks:
            gc.callbacks.remove(self._cb)

    def summary(self) -> str:
        return ", ".join(f"gen{g} {self.n[g]} in {self.s[g]:.4f} s"
                         for g in range(3))


def card_line() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out


def make_session(torch, spec: dict, seed: int, device):
    from mageslam_tpu_torch import MageSlamSettings
    from mageslam_tpu_torch.geometry.camera import CameraCalibration
    from mageslam_tpu_torch.runtime.fused import MageSlamTorchFused
    from slambench import generator
    settings = MageSlamSettings.from_json(
        json.dumps(spec["config"]["settings"]))
    c = generator.calibration(spec["traffic"])
    cal = CameraCalibration.pinhole(c["fx"], c["fy"], c["cx"], c["cy"],
                                    c["width"], c["height"])
    return MageSlamTorchFused(settings, cal, seed=int(seed) & SEED_MASK,
                              device=device), settings


def frames_needed(traffic: dict, seconds: float) -> int:
    """Warm-up plus the longest window at ``max_fps`` frames a second."""
    return int(traffic["warmup_frames"]) \
        + int(math.ceil(float(traffic["max_fps"]) * seconds)) + 1


def make_frames(torch, traffic: dict, seed: int, seconds: float, device):
    """Frames rendered on ``device``, then one copy into pinned host
    memory: (numpy (N, H, W) uint8 view, the pinned tensor)."""
    from slambench import generator
    n = frames_needed(traffic, seconds)
    dev = generator.render(traffic, seed, n, device)
    host = torch.empty(dev.shape, dtype=torch.uint8,
                       pin_memory=dev.device.type == "cuda")
    host.copy_(dev)
    del dev
    return host.numpy(), host


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None, fault=None,
             spec: dict | None = None, control: str | None = None) -> dict:
    """One run of cell ``name``; returns the result object (the contract's
    keys) with ``checks`` last.  ``control`` (``"bf16"`` or ``"tf32"``)
    puts the plain reference, in that precision, in the program's place
    in the check (``check.py``); the program's run is the same."""
    t_start = time.perf_counter() if t_start is None else t_start
    import numpy as np
    import torch
    from mageslam_tpu_torch.ops import fast_cuda
    from slambench import check, nojax, traces

    spec = spec or cell_spec(manifest(), name)
    traffic, cfg = spec["traffic"], spec["config"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    log(f"cell {name}: config {cfg['name']}, traffic "
        f"{spec['cell']['traffic']}, seed {seed}, seconds {seconds}, "
        f"trace {int(trace)}")
    log(f"host threads: torch {torch.get_num_threads()} intra-op, "
        f"{torch.get_num_interop_threads()} inter-op")
    if cuda:
        log(f"card: {torch.cuda.get_device_name(0)}; nvidia-smi: "
            f"{card_line()}")
        fast_cuda.build()
    log(f"set-up: imports and kernel library {time.perf_counter() - t_start:.3f} s")
    t_phase = time.perf_counter()
    frames, _pinned = make_frames(torch, traffic, seed, seconds, dev)
    warm = int(traffic["warmup_frames"])
    log(f"frames made: {len(frames)} ({frames.shape[1]}x{frames.shape[2]} "
        f"uint8, rendered on {dev.type}, pinned on the host) in "
        f"{time.perf_counter() - t_phase:.3f} s; warm-up {warm} frames")
    t_phase = time.perf_counter()
    fused, settings = make_session(torch, spec, seed, dev)
    log(f"set-up: session made in {time.perf_counter() - t_phase:.3f} s")
    t_phase = time.perf_counter()
    probe = Probe(torch, fused, fault)
    probe.track_frames = check.track_sample(seed, warm, len(frames))
    eng = fused.engine

    def sync():
        if cuda:
            torch.cuda.synchronize()

    try:
        for i in range(warm):
            probe.frame = i
            fused.process_frame(frames[i])
        res = fused.flush()
        tracked = [j for j in range(warm)
                   if res[j].state.name == "TRACKING"]
        first = tracked[0] if tracked else -1
        uninitialized = int(not bool(fused.state.initialized))
        st = fused.state
        log(f"warm-up: {time.perf_counter() - t_phase:.3f} s, loop "
            f"detections run {eng.counts['loop_detections']}; first "
            f"tracked frame {first}, initialized at window open: "
            f"{not uninitialized}, last warm-up frame "
            f"{res[warm - 1].state.name}, keyframes alive "
            f"{int(st.map.kf_valid.sum())}, map points "
            f"{int(st.map.mp_valid.sum())}, local-BA window keyframes "
            f"{int(st.ba_window.problem.obs_valid.any(0).sum())}")

        before = dict(eng.counts, syncs=fused.host_syncs,
                      kf_ever=int(st.map.num_kf_ever),
                      loops=int(st.loops_closed))
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        step_events = []
        i = warm
        prof = None
        gc_log = GcLog()
        sync()
        probe.recording = True
        probe.spans_on = bool(trace)
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        start_ev = None
        if cuda:
            start_ev = torch.cuda.Event(enable_timing=True)
            start_ev.record()
        deadline = t0 + (seconds / 2.0 if trace else seconds)
        while time.perf_counter() < deadline:
            if i >= len(frames):
                raise RuntimeError(f"ran out of frames: {len(frames)} made "
                                   f"for {seconds} s")
            probe.frame = i
            fused.process_frame(frames[i])
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                step_events.append(ev)
            i += 1
        sync()
        t1 = time.perf_counter()
        gc_log.close()
        n_spanned = i - warm
        prof_window = None
        if trace:
            # the profiled stretch: no stage syncs, layers labelled
            probe.spans_on = False
            probe.annotate = True
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof_first = i
            with torch.profiler.profile(activities=acts) as prof:
                tp0 = time.perf_counter()
                for _ in range(PROFILED_FRAMES):
                    if i >= len(frames):
                        raise RuntimeError("ran out of frames")
                    probe.frame = i
                    fused.process_frame(frames[i])
                    i += 1
                sync()
                tp1 = time.perf_counter()
            probe.annotate = False
            prof_window = (prof_first, i, tp1 - tp0)
            log(f"trace: {PROFILED_FRAMES} frames profiled in "
                f"{tp1 - tp0:.3f} s, profiler closed in "
                f"{time.perf_counter() - tp1:.3f} s")
        probe.recording = False
        n_window = i - warm
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        res = fused.flush()
        codes = [res[j].state.name if j in res else None
                 for j in range(warm, i)]
        st = fused.state
        after = dict(eng.counts, syncs=fused.host_syncs,
                     kf_ever=int(st.map.num_kf_ever),
                     loops=int(st.loops_closed))
        kf_alive = int(st.map.kf_valid.sum())
    finally:
        probe.close()

    log(f"window GC: {gc_log.summary()}")
    failed = sum(c != "TRACKING" for c in codes)
    unanswered = sum(c is None for c in codes)
    d = {k: after[k] - before[k] for k in after}
    log(f"window: {n_window} frames submitted ({warm}-{i - 1}), "
        f"{n_window - failed} tracked, {failed} not tracking, "
        f"{unanswered} unanswered; frames made {len(frames)}, used {i}")
    log(f"window events: keyframes inserted {d['kf_ever']}, keyframes "
        f"alive {kf_alive}, force culls {probe.force_culls}, "
        f"relocalizations tried {d['reloc_tried']} accepted "
        f"{d['reloc_accepted']}, loop detections run "
        f"{d['loop_detections']} (gated out {d['loop_no_candidates']}), "
        f"loops closed {d['loops']}, host syncs {d['syncs']}")

    metrics = {}
    device_info = dict(platform="gpu" if cuda else dev.type,
                       kind=torch.cuda.get_device_name(0) if cuda
                       else "cpu", count=1, memory_peak_bytes=int(peak))
    breakdown = None
    if not trace:
        wall = t1 - t0
        steps_ms = []
        if cuda:
            prev = start_ev
            for ev in step_events:
                steps_ms.append(prev.elapsed_time(ev))
                prev = ev
        values = dict(frames_per_s=n_window / wall, setup_s=setup_s,
                      frame_ms_p95=float(np.percentile(steps_ms, 95))
                      if steps_ms else None)
        for m in spec["end_to_end"]:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = dict(value=values[m["name"]],
                                          unit=m["unit"])
        log(f"window wall {wall:.4f} s, setup {setup_s:.4f} s, "
            f"frames/s {n_window / wall:.4f}, step ms p50 "
            f"{np.percentile(steps_ms, 50) if steps_ms else float('nan'):.3f}"
            f" p95 {values['frame_ms_p95'] or float('nan'):.3f}")
        if steps_ms:
            # how the step time spreads, and whether it drifts in the window
            dec = np.percentile(steps_ms, np.arange(10, 100, 10))
            quarters = [float(np.sum(q)) / 1e3 / len(q)
                        for q in np.array_split(np.asarray(steps_ms), 4)]
            log("step ms deciles: " + " ".join(f"{v:.1f}" for v in dec))
            log("mean step s by quarter of the window: "
                + " ".join(f"{v:.4f}" for v in quarters))
    else:
        ctx = dict(frames=frames, spanned_frames=n_spanned,
                   span_s=dict(probe.span_s), syncs=d["syncs"],
                   window_frames=n_window, settings=settings)
        if prof is not None and cuda:
            t_red = time.perf_counter()
            ctx.update(traces.reduce(prof, prof_window, frames))
            log(f"trace: reduced in {time.perf_counter() - t_red:.3f} s")
            device_info["busy_s"] = ctx["busy_s"]
            device_info["window_s"] = ctx["window_s"]
            breakdown = ctx["breakdown"]
        for m in spec["per_layer"]:
            v = load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
        log("per-layer: " + ", ".join(f"{k} {v['value']:.6g}"
                                      for k, v in metrics.items()))

    # the program's session goes before the reference runs
    del fused, st, res, eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = check.run(probe, frames, spec, seed, dev, control=control,
                       extra=dict(unanswered=unanswered,
                                  uninitialized=uninitialized),
                       tracked={warm + k for k, c in enumerate(codes)
                                if c == "TRACKING"})
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    found = nojax.loaded_banned(sys.modules)
    if found:
        log(f"no-JAX check FAILED: loaded {found}")
        raise SystemExit(3)
    log("no-JAX check: no module named jax, jaxlib, flax or mageslam_tpu "
        "is loaded")
    out = dict(correct=bool(correct), attempted=n_window, failed=failed,
               metrics=metrics, device=device_info)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
