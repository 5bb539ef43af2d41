#!/usr/bin/env python3
"""The engine step's own spans and counters on one NVIDIA GPU, and what
the program's tracer costs.

    python3 tools/profile_torch_spans.py [--seed N]
        [--cell console320-explore:60] [--cell console320-look:200]
        [--out spans.json]

For each benchmark cell named (``BENCHMARK.json``; by default both, with
60 and 200 window frames) it runs four sessions of the same seed in turns
with the program's tracer (``mageslam_tpu_torch.utils.tracing``'s
``PROFILER``) off, on, on, off, each in a process of its own (a process
that ran a session and a profiler before times their leftovers, and a
second ``torch.profiler`` run in one process drops kernel records).  Each
renders the cell's frames from the seed as ``slambench/run.py`` does,
runs the cell's warm-up with the tracer off, then the window frames with
the tracer as its turn says, timed between two device syncs (frames/s; no
stage syncs, no profiler), then 6 more frames under ``torch.profiler``
with the clock anchor of ``slambench/spans.py``, the tracer still as the
turn says.

Per cell it prints one JSON line: frames/s of each turn and the tracer's
cost (the mean of the on turns over the mean of the off turns, less 1);
the kernel count of each turn's profiled frames (by
``slambench/traces.py``, the benchmark's own reduction) and the kernel
names whose counts differ from the first turn's; whether every turn's
output rows are bitwise equal; from the first on turn, the span readers of
``slambench/metrics/`` (``spans.stretch_ctx``), the counters' changes, the
span table (self ms a frame over the window; kernels and device-idle ms a
frame over the profiled frames), how the ``mapping`` span's time splits
among its children, and the innermost span at each of the 10 longest idle
gaps beside ``traces.reduce``'s names for them.  It also times an empty
scope on the host with the tracer off and on (``scope_ns``).  ``--out``
also gets the lines as one JSON file.  Without a CUDA card it exits with
code 2; ``--cpu`` (with ``--warmup`` to cut the warm-up) rehearses the
path on the CPU, where no device number is made.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PROFILED = 6
TURNS = (False, True, True, False)
DEFAULT_CELLS = ("console320-explore:60", "console320-look:200")
READERS = ("sync_wait_ms_per_frame", "local_ba_ms_per_lm_step",
           "keyframe_insert_ms_per_keyframe",
           "loop_detection_ms_per_attempt", "track_match_ms_per_frame",
           "pose_refine_ms_per_frame")
SCOPES = 200_000


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def scope_cost_ns() -> dict:
    """Host nanoseconds of one empty scope of a private tracer, off and
    on (the spans it records are dropped)."""
    from mageslam_tpu_torch.utils.tracing import Profiler
    out = {}
    for on in (False, True):
        p = Profiler(enabled=on)
        t0 = time.perf_counter_ns()
        for _ in range(SCOPES):
            with p.scope("x"):
                pass
        out["on" if on else "off"] = (time.perf_counter_ns() - t0) / SCOPES
        p.take_spans()
    return out


def turn(name: str, n_window: int, seed: int, tracer_on: bool, dev,
         warmup=None) -> dict:
    """One session in this process: the frames, the warm-up, the window,
    then the profiled frames."""
    import numpy as np
    import torch
    from slambench import harness, spans, traces
    spec = harness.cell_spec(harness.manifest(), name)
    if warmup is not None:
        spec["traffic"]["warmup_frames"] = warmup
    warm = int(spec["traffic"]["warmup_frames"])
    seconds = (warm + n_window + PROFILED) \
        / float(spec["traffic"]["max_fps"])
    frames, _pinned = harness.make_frames(torch, spec["traffic"], seed,
                                          seconds, dev)
    tr = spans.tracer()
    fused, _ = harness.make_session(torch, spec, seed, dev)
    eng = fused.engine
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    for i in range(warm):
        fused.process_frame(frames[i])
    fused.flush()
    sync()
    before = dict(eng.counts, host_syncs=eng.host_syncs)
    tr.take_spans()
    tr.enabled = tracer_on
    t0 = time.perf_counter()
    for i in range(warm, warm + n_window):
        fused.process_frame(frames[i])
    sync()
    t1 = time.perf_counter()
    tr.enabled = False
    window_spans = tr.take_spans()
    after = dict(eng.counts, host_syncs=eng.host_syncs)
    out = dict(tracer=tracer_on, frames_per_s=n_window / (t1 - t0),
               counts={k: after[k] - before[k] for k in after})
    if tracer_on:
        out["ctx"] = spans.stretch_ctx(window_spans, n_window, before, after)
        out["spans_per_frame"] = len(window_spans) / n_window
        out["sync_spans"] = sum(s.name == "sync" for s in window_spans)
    end = warm + n_window
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    tr.enabled = tracer_on
    with torch.profiler.profile(activities=acts) as prof:
        anchor_ns = spans.anchor()
        tp0 = time.perf_counter()
        for i in range(end, end + PROFILED):
            fused.process_frame(frames[i])
        sync()
        tp1 = time.perf_counter()
    tr.enabled = False
    prof_spans = tr.take_spans()
    red = traces.reduce(prof, (end, end + PROFILED, tp1 - tp0), frames)
    events = list(prof.events())
    out.update(kernels=red["kernels"],
               idle_pct=100 * (1 - red["busy_s"] / red["window_s"]),
               idle_gaps=red["breakdown"]["idle_gaps"],
               kernel_names=Counter(e.name for e in events
                                    if spans._kernel(e)),
               anchor_device_events=sum(
                   e.name == spans.ANCHOR and "CUDA" in str(e.device_type)
                   for e in events))
    if tracer_on:
        out["attributed"] = spans.attribute(events, prof_spans, anchor_ns)
    fused.flush()
    rows = np.stack([fused.output_row(f)
                     for f in range(warm, end + PROFILED)])
    out["rows_sha256"] = hashlib.sha256(rows.tobytes()).hexdigest()
    out["card"] = harness.card_line() if cuda else "cpu"
    return out


def mapping_split(ctx) -> dict:
    """How the ``mapping`` spans' time splits: the ``mapping.*`` stages
    (their syncs included), the blocking reads of ``advance_mapping``
    itself, and what no child covers."""
    total = ctx["tracer_span_s"].get("mapping")
    if not total:
        return {}
    own = ctx["tracer_self_s"]
    stages = sum(v for k, v in ctx["tracer_span_s"].items()
                 if k.startswith("mapping."))
    return dict(mapping_ms=1e3 * total, stages_share=stages / total,
                sync_share=own.get("frame/mapping/sync", 0.0) / total,
                self_share=own.get("frame/mapping", 0.0) / total)


def run_cell(name: str, n_window: int, seed: int, extra: list) -> dict:
    """The cell's turns, each in a new process of this script."""
    turns = []
    for k, on in enumerate(TURNS):
        t0 = time.perf_counter()
        cmd = [sys.executable, __file__, "--turn", "on" if on else "off",
               "--cell", f"{name}:{n_window}", "--seed", str(seed), *extra]
        done = subprocess.run(cmd, stdout=subprocess.PIPE, text=True,
                              check=True)
        out = json.loads(done.stdout.strip().splitlines()[-1])
        turns.append(out)
        log(f"{name} turn {k} tracer {'on' if on else 'off'}: "
            f"{out['frames_per_s']:.4f} frames/s, kernels "
            f"{out['kernels']}, {time.perf_counter() - t0:.1f} s")
    fps_on = [t["frames_per_s"] for t in turns if t["tracer"]]
    fps_off = [t["frames_per_s"] for t in turns if not t["tracer"]]
    first_on = next(t for t in turns if t["tracer"])
    ctx = first_on["ctx"]
    names0 = Counter(turns[0]["kernel_names"])
    from slambench import harness, spans
    return dict(
        cell=name, seed=seed, window_frames=n_window, card=turns[0]["card"],
        tracer=[t["tracer"] for t in turns],
        frames_per_s=[t["frames_per_s"] for t in turns],
        tracer_cost=statistics.mean(fps_on) / statistics.mean(fps_off) - 1,
        spans_per_frame=first_on["spans_per_frame"],
        kernels=[t["kernels"] for t in turns],
        kernel_name_changes=[
            {n[:80]: c[n] - names0[n] for n in set(names0) | set(c)
             if c[n] != names0[n]}
            for c in (Counter(t["kernel_names"]) for t in turns[1:])],
        anchor_device_events=[t["anchor_device_events"] for t in turns],
        idle_pct=[t["idle_pct"] for t in turns],
        rows_equal=len({t["rows_sha256"] for t in turns}) == 1,
        metrics={m: harness.load_reader(m)(ctx) for m in READERS},
        metrics_second_on={m: harness.load_reader(m)(turns[2]["ctx"])
                           for m in READERS},
        counts=first_on["counts"], sync_spans=first_on["sync_spans"],
        mapping=mapping_split(ctx),
        spans=spans.span_table(ctx, first_on["attributed"], PROFILED),
        gap_spans=first_on["attributed"]["gap_spans"],
        idle_gaps=first_on["idle_gaps"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2718281828)
    ap.add_argument("--cell", action="append",
                    help="NAME:WINDOW_FRAMES (repeatable)")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU (no device numbers)")
    ap.add_argument("--warmup", type=int,
                    help="warm-up frames in place of the cell's")
    ap.add_argument("--turn", choices=("off", "on"),
                    help="run one session of the first --cell here")
    args = ap.parse_args(argv)
    from slambench import run
    run.fix_environment()
    import torch
    if not args.cpu and not torch.cuda.is_available():
        log("profile_torch_spans: needs a CUDA card (--cpu rehearses)")
        return 2
    torch.set_num_threads(run.THREADS)
    torch.set_num_interop_threads(run.INTEROP_THREADS)
    dev = torch.device("cpu" if args.cpu else "cuda")
    if not args.cpu:
        from mageslam_tpu_torch.ops import fast_cuda
        fast_cuda.build()
    cells = [(c.split(":")[0], int(c.split(":")[1]))
             for c in args.cell or DEFAULT_CELLS]
    if args.turn is not None:
        name, n_window = cells[0]
        print(json.dumps(turn(name, n_window, args.seed, args.turn == "on",
                              dev, args.warmup)), flush=True)
        return 0
    extra = ["--cpu"] * args.cpu
    if args.warmup is not None:
        extra += ["--warmup", str(args.warmup)]
    results = [dict(scope_ns=scope_cost_ns())]
    print(json.dumps(results[0]), flush=True)
    for name, n_window in cells:
        res = run_cell(name, n_window, args.seed, extra)
        print(json.dumps(res), flush=True)
        results.append(res)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
