"""The port's tracer on the fused path (``utils/tracing.py``).

A fused session on the CPU over the first frames of
``tests/data/torch_orbit60.npz`` at the console's ``fast_settings()``
initializes, inserts a keyframe and runs local BA.  It is driven twice
from the same seed, with ``PROFILER`` on and off: the spans nest under one
``frame`` span per frame, the engine's counters match what they count, and
the output rows do not depend on the tracer.  Self time comes from the
recorded tree; ``slambench/spans.py``'s clock anchor puts a span around an
operation that ``torch.profiler`` recorded.
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

from mageslam_tpu_torch.geometry.camera import CameraCalibration
from mageslam_tpu_torch.runtime import device_engine as de
from mageslam_tpu_torch.runtime.fused import MageSlamTorchFused
from mageslam_tpu_torch.utils import tracing
from mageslam_tpu_torch.utils.tracing import Profiler, Span, self_ns

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples"))
import console_torch  # noqa: E402
from slambench import spans as bench_spans  # noqa: E402

FIXTURE = os.path.join(ROOT, "tests", "data", "torch_orbit60.npz")
FRAMES = 14
STAGES = {"frontend", "fingerprints", "init", "mapping", "tracking", "sync"}
MAPPING = {"mapping.local_ba", "mapping.insert_keyframe",
           "mapping.reopen_window", "mapping.finish", "mapping.loop"}
TRACKING = {"tracking.local_map", "tracking.match", "tracking.refine",
            "tracking.keyframe_decision", "tracking.relocalize"}

torch.set_num_threads(2)


def drive(traced: bool) -> dict:
    """FRAMES frames through ``process_frame``; per frame the engine's
    counters, host syncs, ``num_kf_ever`` and local-BA calls before and
    after it."""
    z = np.load(FIXTURE)
    fx, fy, cx, cy, w, h = z["cal"].tolist()
    cal = CameraCalibration.pinhole(fx, fy, cx, cy, int(w), int(h))
    fused = MageSlamTorchFused(console_torch.fast_settings(), cal, seed=1,
                               device="cpu")
    eng = fused.engine
    calls = []
    orig = de.bundle_adjust_impl

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    def snapshot():
        return dict(eng.counts, host_syncs=eng.host_syncs, ba_calls=len(calls),
                    kf_ever=int(fused.state.map.num_kf_ever))

    de.bundle_adjust_impl = counting
    tracing.PROFILER.take_spans()
    tracing.PROFILER.enabled = traced
    log = []
    try:
        for i in range(FRAMES):
            before = snapshot()
            fused.process_frame(z["imgs"][i], timestamp=i / 30.0)
            log.append((before, snapshot()))
    finally:
        tracing.PROFILER.enabled = False
        de.bundle_adjust_impl = orig
    spans = tracing.PROFILER.take_spans()
    fused.flush()
    rows = np.stack([fused.output_row(i) for i in range(FRAMES)])
    return dict(spans=spans, rows=rows, log=log, ba_per_run=eng.ba_per_run)


@pytest.fixture(scope="module")
def traced():
    return drive(True)


@pytest.fixture(scope="module")
def untraced():
    return drive(False)


def test_spans_nest_under_one_frame_span_per_frame(traced):
    spans = traced["spans"]
    roots = [s for s in spans if s.parent < 0]
    assert [s.name for s in roots] == ["frame"] * FRAMES
    assert [s.frame for s in roots] == list(range(FRAMES))
    names = {s.name for s in spans}
    assert {"frame", "mapping.local_ba", "mapping.insert_keyframe",
            "tracking.local_map", "tracking.match", "tracking.refine",
            "tracking.keyframe_decision"} | STAGES <= names, names
    assert names <= {"frame"} | STAGES | MAPPING | TRACKING
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent < 0:
            continue
        p = spans[s.parent]
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        assert s.frame == p.frame
        if s.name in STAGES - {"sync"}:
            assert p.name == "frame", s
        elif s.name in MAPPING:
            assert p.name == "mapping", s
        elif s.name in TRACKING:
            assert p.name == "tracking", s
    for r in range(FRAMES):
        branch = [s.name for s in spans if s.frame == r
                  and s.name in ("init", "tracking")]
        assert len(branch) == 1, (r, branch)
    # the tracker's matching is two spans a frame: three widening rounds,
    # then the search after the first refinement; as many refinements
    n_track = sum(s.name == "tracking" for s in spans)
    assert sum(s.name == "tracking.match" for s in spans) == 2 * n_track
    assert sum(s.name == "tracking.refine" for s in spans) == 2 * n_track


def test_counters_match_what_they_count(traced):
    log = traced["log"]
    per_run = traced["ba_per_run"]
    spans = traced["spans"]

    def delta(k, before, after):
        return after[k] - before[k]

    inserted = 0
    for f, (b, a) in enumerate(log):
        assert delta("lm_steps", b, a) == per_run * delta("ba_calls", b, a)
        assert sum(s.name == "sync" and s.frame == f for s in spans) \
            == delta("host_syncs", b, a), f
        if a["kf_ever"] >= b["kf_ever"]:   # no reset to an empty map
            assert delta("keyframes_inserted", b, a) \
                == delta("kf_ever", b, a), f
            inserted += delta("keyframes_inserted", b, a)
    b, a = log[0][0], log[-1][1]
    assert delta("ba_calls", b, a) > 0 and inserted > 2
    opened = sum(s.name in ("mapping.insert_keyframe",
                            "mapping.reopen_window") for s in spans)
    assert delta("ba_windows_opened", b, a) == opened > 0
    assert delta("force_culls", b, a) == 0


def test_output_rows_do_not_depend_on_the_tracer(traced, untraced):
    assert np.array_equal(traced["rows"].view(np.uint32),
                          untraced["rows"].view(np.uint32))
    assert untraced["spans"] == []


def test_self_time_is_duration_less_children():
    spans = [Span("a", 0, 100, -1, 3), Span("b", 10, 30, 0, 3),
             Span("c", 40, 90, 0, 3), Span("d", 50, 60, 2, 3)]
    assert self_ns(spans) == [30, 20, 40, 10]


def test_self_times_add_up_to_each_frame(traced):
    spans = traced["spans"]
    own = self_ns(spans)
    kids = {}
    for i, s in enumerate(spans):
        if s.parent >= 0:
            kids[s.parent] = kids.get(s.parent, 0) + s.end_ns - s.start_ns
    for i, s in enumerate(spans):
        assert own[i] == s.end_ns - s.start_ns - kids.get(i, 0) >= 0
    for r in range(FRAMES):
        root = next(s for s in spans if s.parent < 0 and s.frame == r)
        assert sum(o for s, o in zip(spans, own) if s.frame == r) \
            == root.end_ns - root.start_ns


def test_anchor_puts_spans_on_the_profiler_clock():
    p = Profiler()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        anchor_ns = bench_spans.anchor()
        time.sleep(0.003)
        torch.arange(64.0).cumsum(0)
        time.sleep(0.003)
        with p.scope("inside", frame=0):
            time.sleep(0.002)
            torch.arange(64.0).sum()
            time.sleep(0.002)
        time.sleep(0.003)
    events = list(prof.events())
    off = bench_spans.offset_us(events, anchor_ns)
    (span,) = p.take_spans()
    s0, s1 = span.start_ns * 1e-3 + off, span.end_ns * 1e-3 + off
    (inside,) = [e for e in events if e.name == "aten::sum"]
    (outside,) = [e for e in events if e.name == "aten::cumsum"]
    assert s0 < inside.time_range.start and inside.time_range.end < s1
    assert outside.time_range.end < s0
    segs = bench_spans.segments([span], off)
    assert bench_spans._at(segs, inside.time_range.start) == "inside"
    assert bench_spans._at(segs, outside.time_range.start) \
        == bench_spans.OUTSIDE
