"""Tracing and introspection of the port.

``Profiler`` is the port's one tracer, and ``PROFILER`` its global
instance, off by default as the reference's SCOPE_TIMER is empty in its
public drop (Utils/Logging.h:6).  Off, ``scope(name)`` costs one attribute
test and records nothing.  On, each scope adds to the aggregate ``stats``
that ``report()`` prints and records a ``Span``: its name, its start and
end on the host clock (``time.perf_counter_ns``), the index of its parent
span and the frame id of the engine step it belongs to.  Spans stay in
memory until ``take_spans()`` hands them out; ``self_ns`` derives each
span's self time (its duration less the parts its children cover) from the
recorded tree.

The clock is the host's and a scope adds no synchronisation.  On the card
a span therefore measures the host's part of its stage -- dispatch,
launches and the waits inside it -- not the device's time: kernels are
queued and the call returns before they finish.  The ``sync`` spans,
around the engine's blocking reads, say how much of that was waiting.

Spans on the fused path (``runtime/fused.py``, ``runtime/device_engine.py``,
``tracking/track.py``), placed at stage boundaries only; iterations inside
a stage (LM steps, refinement iterations, RANSAC hypotheses) are counted
in ``DeviceEngine.counts`` instead:

  frame                      ``MageSlamTorchFused._dispatch``: one engine
                             step and the facade's output fetch; carries
                             the frame id
    frontend                 feature extraction and BoW training
    fingerprints             the step's determinism hashes and output row
    init                     the initialization branch
    mapping                  ``DeviceEngine.advance_mapping``
      mapping.local_ba       the local-BA call and its write-back
      mapping.insert_keyframe  ``drain_pending``
      mapping.reopen_window  ``reopen_window``
      mapping.finish         ``finish_mapping`` less its loop attempt
      mapping.loop           ``try_loop``
    tracking                 ``DeviceEngine.track_branch``
      tracking.local_map     covisibility, candidate gates, compaction
      tracking.match         radius searches with unique assignment
      tracking.refine        pose refinements
      tracking.keyframe_decision  the decision and the keyframe's enqueue
      tracking.relocalize    ``relocalize_frame``
    sync                     a blocking device read (``DeviceEngine._read``,
                             the facade's wait on its copied output rows),
                             under the stage that waited

Also here: the reference's SkeletonLogger leveled data logger
(Debugging/SkeletonLogger.h:27-136), ``SkeletonLogger`` with bitmask levels.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from enum import IntFlag
from typing import Any, NamedTuple


# ---------------------------------------------------------------------------
# scope timers and spans
# ---------------------------------------------------------------------------

@dataclass
class ScopeStats:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    @property
    def mean_ms(self) -> float:
        return 1000.0 * self.total_s / max(self.count, 1)


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int       # index of the parent span in the same list; -1: none
    frame: int        # frame id of the engine step; -1 outside one


def self_ns(spans: list[Span]) -> list[int]:
    """Each span's duration less its children's (which never overlap one
    another: a scope closes before its sibling opens)."""
    out = [s.end_ns - s.start_ns for s in spans]
    for s in spans:
        if s.parent >= 0:
            out[s.parent] -= s.end_ns - s.start_ns
    return out


_OFF = contextlib.nullcontext()


class _Scope:
    __slots__ = ("prof", "name", "frame", "rec")

    def __init__(self, prof: "Profiler", name: str, frame):
        self.prof, self.name, self.frame = prof, name, frame

    def __enter__(self):
        p = self.prof
        parent = p._open[-1] if p._open else -1
        frame = self.frame
        if frame is None:
            frame = p._spans[parent][4] if parent >= 0 else -1
        p._open.append(len(p._spans))
        # [name, start, end, parent, frame]: a Span once it closes
        self.rec = [self.name, time.perf_counter_ns(), -1, parent, frame]
        p._spans.append(self.rec)

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        p = self.prof
        p._open.pop()
        self.rec[2] = t1
        dt = (t1 - self.rec[1]) * 1e-9
        s = p.stats[self.name]
        s.count += 1
        s.total_s += dt
        s.max_s = max(s.max_s, dt)
        return False


class Profiler:
    """Named scopes (SCOPE_TIMER analog) that record spans.  Thread-unsafe
    by design -- one per pipeline, like the reference's per-thread
    instrumentation; sessions in one process share ``PROFILER``."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.stats: dict[str, ScopeStats] = defaultdict(ScopeStats)
        self._spans: list[list] = []
        self._open: list[int] = []

    def scope(self, name: str, frame: int | None = None):
        """A context manager timing ``name``; ``frame`` sets the span's
        frame id, which its descendants inherit."""
        if not self.enabled:
            return _OFF
        return _Scope(self, name, frame)

    def take_spans(self) -> list[Span]:
        """The spans recorded since the last call, in the order they
        opened (parents index into this list); none may still be open."""
        if self._open:
            raise RuntimeError(f"{len(self._open)} span(s) still open")
        spans, self._spans = self._spans, []
        return [Span(*r) for r in spans]

    def report(self) -> str:
        lines = [f"{'scope':<40} {'count':>7} {'mean ms':>9} {'max ms':>9}"]
        for name, s in sorted(self.stats.items(),
                              key=lambda kv: -kv[1].total_s):
            lines.append(f"{name:<40} {s.count:>7} {s.mean_ms:>9.2f} "
                         f"{1000 * s.max_s:>9.2f}")
        return "\n".join(lines)


PROFILER = Profiler(enabled=False)  # global default, off like the reference


def scope_timer(name: str):
    return PROFILER.scope(name)


# ---------------------------------------------------------------------------
# skeleton logger (leveled diagnostic data)
# ---------------------------------------------------------------------------

class SkeletonLoggerLevel(IntFlag):  # SkeletonKey.h:14-25
    NONE = 0
    INITIALIZATION = 1
    TRACKING = 2
    MAPPING = 4
    IMAGE = 8
    MODEL = 16
    ALL = 31


@dataclass
class SkeletonLogger:
    level: SkeletonLoggerLevel = SkeletonLoggerLevel.NONE
    records: list = field(default_factory=list)

    def log(self, level: SkeletonLoggerLevel, message: str,
            data: Any = None):
        if self.level & level:
            self.records.append((time.time(), level, message, data))

    def for_level(self, level: SkeletonLoggerLevel):
        return [r for r in self.records if r[1] & level]
