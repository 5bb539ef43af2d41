"""Tracing / profiling / introspection.

A copy of ``mageslam_tpu/utils/tracing.py`` (it holds no JAX).  The scope
timers read the host clock.  On the card a scope around an engine call
therefore measures the host's part of it, launches included, and not the
device's time: kernels are queued and the call returns before they finish
(as JAX's asynchronous dispatch returns before its device work).  The
timers add no synchronisation; to time device work, close the scope after a
host read of a result or a ``torch.cuda.synchronize()``.

Equivalents of the reference's observability stack (SURVEY.md §5):
  - SCOPE_TIMER(name) (Utils/Logging.h:6 — defined empty in the public
    drop; originally ETW scoped timers): ``scope_timer`` context manager
    accumulating wall-time stats per named scope (``torch.profiler``
    traces the device).
  - FIRE_OBJECT_TRACE typed data-point channels (arcana/analysis/
    object_trace.h:15-21): ``ObjectTrace`` pub/sub with in-process
    listeners.
  - Introspection fan-out (Debugging/Introspection.h:13-40) and the
    SkeletonLogger leveled data logger (Debugging/SkeletonLogger.h:27-136):
    ``SkeletonLogger`` with bitmask levels.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from enum import IntFlag
from typing import Any, Callable


# ---------------------------------------------------------------------------
# scope timers
# ---------------------------------------------------------------------------

@dataclass
class ScopeStats:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    @property
    def mean_ms(self) -> float:
        return 1000.0 * self.total_s / max(self.count, 1)


class Profiler:
    """Named scoped timers (SCOPE_TIMER analog).  Thread-unsafe by design —
    one per pipeline, like the reference's per-thread instrumentation."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.stats: dict[str, ScopeStats] = defaultdict(ScopeStats)

    @contextlib.contextmanager
    def scope(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            s = self.stats[name]
            s.count += 1
            s.total_s += dt
            s.max_s = max(s.max_s, dt)

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
# object traces (typed pub/sub data points)
# ---------------------------------------------------------------------------

class ObjectTrace:
    """FIRE_OBJECT_TRACE analog: typed channels + listeners."""

    def __init__(self):
        self._listeners: dict[str, list[Callable[[Any], None]]] = \
            defaultdict(list)
        self._history: dict[str, list[Any]] = defaultdict(list)
        self.keep_history = False

    def listen(self, channel: str, fn: Callable[[Any], None]):
        self._listeners[channel].append(fn)

    def fire(self, channel: str, value: Any):
        if self.keep_history:
            self._history[channel].append(value)
        for fn in self._listeners[channel]:
            fn(value)

    def history(self, channel: str):
        return list(self._history[channel])


TRACES = ObjectTrace()


def fire_object_trace(channel: str, value: Any):
    TRACES.fire(channel, value)


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
