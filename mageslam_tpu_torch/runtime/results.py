"""Per-frame tracking results (the JAX package defines these in
``runtime/slam.py``, which imports jax)."""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Optional

import numpy as np


class TrackingState(Enum):
    SKIPPED = "skipped"
    INITIALIZING = "initializing"
    TRACKING = "tracking"
    RELOCALIZING = "relocalizing"


@dataclasses.dataclass
class TrackingResult:
    frame_id: int
    timestamp: float
    state: TrackingState
    pose: Optional[np.ndarray] = None       # (7,) view pose when tracked


def state_codes(states) -> np.ndarray:
    """int8 codes of ``states`` in the engine's numbering
    (``device_engine.CODE_*``: 0 skipped, 1 initializing, 2 tracking,
    3 relocalizing)."""
    order = list(TrackingState)
    return np.array([order.index(s) for s in states], np.int8)
