"""The program's own spans and counters, and their place on a device trace.

``mageslam_tpu_torch.utils.tracing.PROFILER`` records spans on the host
clock (``time.perf_counter_ns``); ``DeviceEngine.counts`` counts the units
of work.  This module turns them into what the readers
``slambench/metrics/{sync_wait_ms_per_frame, local_ba_ms_per_lm_step,
keyframe_insert_ms_per_keyframe, loop_detection_ms_per_attempt,
track_match_ms_per_frame, pose_refine_ms_per_frame}.py`` read, and places
them on a ``torch.profiler`` trace:

- ``anchor()``, called once inside the profiled stretch, pairs the host
  clock with the profiler's through a single ``record_function`` (the
  program itself emits no profiler annotation, so the trace's device set
  is the one ``traces.py`` counts without it);
- ``attribute`` names, for each span path, the kernels launched while the
  host was innermost in it (a kernel's launch time is that of the
  ``cudaLaunchKernel`` the profiler correlates with it) and the device's
  idle time during it, and the innermost span at each of the longest idle
  gaps;
- ``stretch_ctx`` sums the spans and counter deltas of a stretch run with
  the tracer on and nothing else (no stage syncs, no profiler).

A span path is the names from the root span down, joined by ``/``:
``frame/mapping/sync`` is a blocking read in the mapping stage.  Nothing
here imports the program: a program without the tracer gives no spans,
and then every reader returns ``None``.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict

from slambench.traces import TOP, _device

ANCHOR = "slambench.clock_anchor"
OUTSIDE = "(outside spans)"
# the CUDA runtime or driver call that launched a kernel or copy
_LAUNCH = re.compile(r"^cu(da)?[A-Z]")


def tracer():
    """The program's tracer, or ``None`` where the program has none that
    records spans."""
    from mageslam_tpu_torch.utils import tracing
    prof = getattr(tracing, "PROFILER", None)
    return prof if hasattr(prof, "take_spans") else None


def anchor() -> int:
    """One ``record_function`` event on the profiler's clock and a
    ``perf_counter_ns`` read inside it; call inside a profiled region."""
    import torch
    with torch.profiler.record_function(ANCHOR):
        return time.perf_counter_ns()


def offset_us(events, anchor_ns: int) -> float:
    """Add to ``span.start_ns / 1e3`` to get the profiler's microseconds:
    the anchor event's midpoint less the host read taken inside it."""
    for e in events:
        if e.name == ANCHOR:
            mid = 0.5 * (e.time_range.start + e.time_range.end)
            return mid - anchor_ns * 1e-3
    raise ValueError(f"no {ANCHOR!r} event in the trace")


def paths(spans) -> list[str]:
    out: list[str] = []
    for s in spans:
        out.append(s.name if s.parent < 0 else f"{out[s.parent]}/{s.name}")
    return out


def segments(spans, off_us: float) -> list[tuple[float, float, str]]:
    """Sorted, disjoint (start, end, path) intervals in profiler
    microseconds: each span's time less its children's."""
    kids = defaultdict(list)
    for i, s in enumerate(spans):
        if s.parent >= 0:
            kids[s.parent].append(i)
    names = paths(spans)
    out = []
    for i, s in enumerate(spans):
        t = s.start_ns * 1e-3 + off_us
        for k in kids[i]:
            c = spans[k]
            out.append((t, c.start_ns * 1e-3 + off_us, names[i]))
            t = c.end_ns * 1e-3 + off_us
        out.append((t, s.end_ns * 1e-3 + off_us, names[i]))
    return sorted(seg for seg in out if seg[1] > seg[0])


def _at(segs, t: float) -> str:
    """Path of the segment holding time ``t``."""
    lo, hi = 0, len(segs)
    while lo < hi:
        mid = (lo + hi) // 2
        if segs[mid][0] <= t:
            lo = mid + 1
        else:
            hi = mid
    if lo and segs[lo - 1][0] <= t < segs[lo - 1][1]:
        return segs[lo - 1][2]
    return OUTSIDE


def _kernel(e) -> bool:
    return _device(e) and e.name != ANCHOR \
        and not e.name.startswith(("Memcpy", "Memset"))


def idle_gaps(events) -> list[tuple[float, float]]:
    """The device's idle intervals between its first and last activity,
    over the activities ``traces.reduce`` counts as busy."""
    dev = sorted((e.time_range.start, e.time_range.end) for e in events
                 if _device(e) and e.name != ANCHOR)
    gaps, cur = [], None
    for s, e in dev:
        if cur is not None and s > cur:
            gaps.append((cur, s))
        cur = e if cur is None else max(cur, e)
    return gaps


def attribute(events, spans, anchor_ns: int) -> dict:
    """Kernels and device-idle microseconds by span path over a profiled
    stretch, and the innermost span path at the midpoint of each of its
    ``TOP`` longest idle gaps (the order of ``traces.reduce``'s
    ``idle_gaps``)."""
    events = list(events)
    segs = segments(spans, offset_us(events, anchor_ns))
    launch = {e.id: e.time_range.start for e in events
              if "CPU" in str(e.device_type) and _LAUNCH.match(e.name)}
    kernels = defaultdict(int)
    for e in events:
        if _kernel(e):
            t = launch.get(e.id)
            kernels["(launch not found)" if t is None else _at(segs, t)] += 1
    gaps = idle_gaps(events)
    idle = defaultdict(float)
    j = 0
    for g0, g1 in gaps:
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        covered = 0.0
        k = j
        while k < len(segs) and segs[k][0] < g1:
            part = min(g1, segs[k][1]) - max(g0, segs[k][0])
            if part > 0:
                idle[segs[k][2]] += part
                covered += part
            k += 1
        idle[OUTSIDE] += (g1 - g0) - covered
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return dict(kernels=dict(kernels), idle_us=dict(idle),
                gap_spans=[[_at(segs, 0.5 * (a + b)), (b - a) * 1e-3]
                           for a, b in longest])


def stretch_ctx(spans, frames: int, before: dict, after: dict) -> dict:
    """What the span readers read from a stretch of ``frames`` frames run
    with the tracer on: each span name's total seconds, each counter's
    change, and each span path's self seconds."""
    from mageslam_tpu_torch.utils.tracing import self_ns
    total = defaultdict(float)
    own = defaultdict(float)
    for s, p, own_ns in zip(spans, paths(spans), self_ns(spans)):
        total[s.name] += (s.end_ns - s.start_ns) * 1e-9
        own[p] += own_ns * 1e-9
    return dict(tracer_frames=frames, tracer_span_s=dict(total),
                tracer_self_s=dict(own),
                tracer_counts={k: after[k] - before[k] for k in after
                               if k in before})


def span_table(ctx: dict, attributed: dict | None, profiled_frames: int):
    """Rows [path, self ms a frame (stretch), kernels a frame and
    device-idle ms a frame (profiled frames)], by self time."""
    n = ctx["tracer_frames"]
    att = attributed or dict(kernels={}, idle_us={})
    names = set(ctx["tracer_self_s"]) | set(att["kernels"]) \
        | set(att["idle_us"])
    rows = []
    for p in names:
        own = ctx["tracer_self_s"].get(p)
        rows.append([p, 1e3 * own / n if own is not None and n else None,
                     att["kernels"].get(p, 0) / profiled_frames
                     if attributed else None,
                     att["idle_us"].get(p, 0.0) * 1e-3 / profiled_frames
                     if attributed else None])
    return sorted(rows, key=lambda r: -(r[1] or 0.0))
