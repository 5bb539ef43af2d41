"""SkeletonKey: privileged inspector over a live engine + introspection bus.

Port of ``mageslam_tpu/runtime/skeleton_key.py`` (the reference's
debugging side door, Core/MAGESLAM/Source/Debugging/SkeletonKey.h:29-52,
crafted via a backdoor lambda in MAGESlam.cpp:132-160, and the
Introspection fan-out, Debugging/Introspection.h:13-40).

Works against either engine of the port, ``runtime/slam.MageSlamTorch``
and ``runtime/fused.MageSlamTorchFused``: both expose ``map_state``; the
pose history is the host engine's ``_history`` or the fused facade's
engine state.  Every getter copies small arrays to the host and returns
numpy, as the JAX getters do; the engine is never changed.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from mageslam_tpu_torch.mapstore import map_state as ms
from mageslam_tpu_torch.mapstore import pose_history as ph
from mageslam_tpu_torch.mapstore import spanning_tree as st
from mageslam_tpu_torch.runtime.fossilized import engine_history
from mageslam_tpu_torch.utils.tracing import SkeletonLogger


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


class Introspector:
    """Base observer (Debugging/Introspection.h).  Override any hook."""

    def on_frame(self, frame_id: int, state: Any, pose):   # pragma: no cover
        pass

    def on_map_snapshot(self, snapshot: dict):              # pragma: no cover
        pass


class Introspection:
    """Fan-out to registered introspectors."""

    def __init__(self):
        self._sinks: List[Introspector] = []

    def register(self, sink: Introspector):
        self._sinks.append(sink)

    def introspect_frame(self, frame_id: int, state: Any, pose):
        for s in self._sinks:
            s.on_frame(frame_id, state, pose)

    def introspect_map(self, snapshot: dict):
        for s in self._sinks:
            s.on_map_snapshot(snapshot)


def craft_skeleton_key(engine) -> "SkeletonKey":
    """CraftSkeletonKey(MAGESlam&) analog (SkeletonKey.h:50)."""
    return SkeletonKey(engine)


class SkeletonKey:
    def __init__(self, engine, logger: Optional[SkeletonLogger] = None):
        self._engine = engine
        self.logger = logger or SkeletonLogger()
        self.introspection = Introspection()

    # --- live map access (GetMapPoints / GetKeyframes analogs) ---------
    @property
    def map_state(self) -> ms.MapState:
        return self._engine.map_state

    def get_map_points(self) -> np.ndarray:
        m = self.map_state
        return _np(m.mp_pos)[_np(m.mp_valid)]

    def get_keyframe_poses(self) -> np.ndarray:
        m = self.map_state
        return _np(m.kf_pose)[_np(m.kf_valid)]

    def get_keyframe_frame_ids(self) -> np.ndarray:
        m = self.map_state
        return _np(m.kf_frame_id)[_np(m.kf_valid)]

    def get_covisibility(self) -> np.ndarray:
        m = self.map_state
        valid = _np(m.kf_valid)
        return _np(ms.covisibility(m))[np.ix_(valid, valid)]

    def get_spanning_tree(self) -> st.SpanningTree:
        """The covisibility graph's max-weight spanning tree, its fields
        as numpy arrays."""
        return st.SpanningTree(*[_np(x) for x in
                                 st.spanning_tree(self.map_state)])

    # --- pose history / trajectory --------------------------------------
    def get_trajectory(self):
        """(frame_ids, (N, 7) world poses) of the tracked history."""
        hist = engine_history(self._engine)
        m = self.map_state
        poses, ok = ph.world_poses(hist, m.kf_pose, m.kf_valid)
        okn = _np(ok)
        return _np(hist.frame_id)[okn], _np(poses)[okn]

    # --- fuser ----------------------------------------------------------
    def get_fuser(self):
        return getattr(self._engine, "_fuser", None)

    # --- snapshot + introspection fan-out -------------------------------
    def snapshot(self) -> dict:
        m = self.map_state
        snap = {
            "num_keyframes": int(m.kf_valid.sum()),
            "num_map_points": int(m.mp_valid.sum()),
            "map_points": self.get_map_points(),
            "keyframe_poses": self.get_keyframe_poses(),
            "keyframe_frame_ids": self.get_keyframe_frame_ids(),
        }
        self.introspection.introspect_map(snap)
        return snap
