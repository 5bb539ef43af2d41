"""A copy of ``mageslam_tpu/utils/mediator.py`` (it holds no JAX).

Typed pub/sub event bus + the tracking event vocabulary.

Equivalent of Arcana's mediator/router (Dependencies/Arcana/Shared/arcana/
messaging/mediator.h:18-41: typed event bus bound to a dispatcher) and the
SLAM event types in Tasks/TrackingEvents.h (AnalysisCompleted :20,
InitCompleted :27, TrackingLost :31, PoseEstimated :33-50 with basis frame,
PoseRefined :52, HistoryUpdated :64-72).

The reference binds listeners to a dispatcher thread; here delivery is
synchronous on the host (the engine's steps run between host calls, so
there is no listener thread to hop to).  Subscription is by event *type*,
mirroring mediator.h's type-indexed channels.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Type


# --- tracking event vocabulary (TrackingEvents.h) -------------------------

@dataclass(frozen=True)
class AnalysisCompleted:
    frame_id: int
    num_features: int


@dataclass(frozen=True)
class InitCompleted:
    frame_id: int
    num_keyframes: int
    num_map_points: int


@dataclass(frozen=True)
class TrackingLost:
    frame_id: int
    consecutive_failures: int


@dataclass(frozen=True)
class PoseEstimated:
    """Estimated pose relative to a basis frame (TrackingEvents.h:33-50:
    poses are published relative to the map snapshot they were computed
    against, so listeners can re-base after BA/loop updates)."""

    frame_id: int
    pose: Any                 # (7,) view pose
    basis_frame_id: int = -1  # -1 = world frame
    num_inliers: int = 0


@dataclass(frozen=True)
class PoseRefined:
    frame_id: int
    pose: Any
    is_keyframe: bool = False
    num_inliers: int = 0


@dataclass(frozen=True)
class HistoryUpdated:
    """Keyframe poses were adjusted (BA write-back / loop closure)."""

    source: str = ""          # "local_ba" | "global_ba" | "loop_closure"


class Mediator:
    """Type-indexed synchronous pub/sub (mediator.h:18-41)."""

    def __init__(self):
        self._subs: Dict[type, List[Callable[[Any], None]]] = {}

    def subscribe(self, event_type: Type, fn: Callable[[Any], None]
                  ) -> Callable[[], None]:
        """Register; returns an unsubscribe callable (the reference returns
        a ticket whose destruction unregisters, ticketed_collection.h)."""
        self._subs.setdefault(event_type, []).append(fn)

        def unsubscribe():
            lst = self._subs.get(event_type, [])
            if fn in lst:
                lst.remove(fn)
        return unsubscribe

    def send(self, event: Any) -> int:
        """Deliver to all listeners of type(event); returns listener count."""
        listeners = list(self._subs.get(type(event), []))
        for fn in listeners:
            fn(event)
        return len(listeners)

    def clear(self):
        self._subs.clear()


# a process-default bus, mirroring the reference's per-Runtime
# TrackingMediator instance (callers may also construct their own)
tracking_mediator = Mediator()
