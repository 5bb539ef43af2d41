"""Carry settings and state across from the JAX package, and back to numpy.

The JAX package's containers (``FrameFeatures``, ``MapState``,
``PoseHistory``, ``Vocabulary``, ``BAProblem``, ``LocalBAWindow``,
``EngineState``) have counterparts here with the same field names, shapes
and dtypes, so conversion is field by field.  The JAX side is read as
numpy arrays (``np.asarray`` of each leaf — this module never imports
jax); 32-bit unsigned descriptor words are viewed as ``int32`` with the
same bits.

Settings cross as JSON text (``settings_from_jax``), so no class of the
JAX package is touched here.

``EngineState.key`` is not carried: ``jax.random`` keys and
``torch.Generator`` states have no common meaning, so the port's engine
draws from its own generator.  After initialization the engine draws
nothing, which is why a carried state steps identically in both engines.
"""

from __future__ import annotations

import numpy as np
import torch

from mageslam_tpu_torch.bow.vocab import Vocabulary
from mageslam_tpu_torch.config import MageSlamSettings
from mageslam_tpu_torch.geometry.camera import CameraCalibration
from mageslam_tpu_torch.mapping.local_ba import LocalBAWindow
from mageslam_tpu_torch.mapstore.map_state import MapState
from mageslam_tpu_torch.mapstore.pose_history import PoseHistory
from mageslam_tpu_torch.runtime.device_engine import EngineState
from mageslam_tpu_torch.solvers.bundle_adjust import BAProblem, check_tethers
from mageslam_tpu_torch.tracking.frontend import FrameFeatures

# fields that hold a nested container, by name
_NESTED = {
    "map": MapState, "history": PoseHistory, "vocab": Vocabulary,
    "init_feats": FrameFeatures, "pend_feats": FrameFeatures,
    "ba_window": LocalBAWindow, "problem": BAProblem,
}
# fields whose JAX dtype is uint32 (descriptor words)
UINT32_FIELDS = frozenset({"desc", "kf_desc", "mp_desc", "train_desc",
                           "l1_desc", "leaf_desc"})


def settings_from_jax(s) -> MageSlamSettings:
    """The port's settings object with the values of a JAX-package
    ``MageSlamSettings``, carried through its JSON form."""
    return MageSlamSettings.from_json(s.to_json())


def tensor_from_numpy(x, device=None) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    # a copy (not np.ascontiguousarray, which turns 0-d arrays into 1-d)
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def from_jax(cls, obj, device=None):
    """Port container of type ``cls`` from a JAX container with the same
    field names (leaves read with ``np.asarray``)."""
    vals = {}
    for name in cls._fields:
        leaf = getattr(obj, name)
        sub = _NESTED.get(name)
        vals[name] = (from_jax(sub, leaf, device) if sub is not None
                      else tensor_from_numpy(leaf, device))
    out = cls(**vals)
    if cls is BAProblem:
        check_tethers(out)
    return out


def features_from_jax(f, device=None) -> FrameFeatures:
    return from_jax(FrameFeatures, f, device)


def map_from_jax(m, device=None) -> MapState:
    return from_jax(MapState, m, device)


def history_from_jax(h, device=None) -> PoseHistory:
    return from_jax(PoseHistory, h, device)


def vocabulary_from_jax(v, device=None) -> Vocabulary:
    return from_jax(Vocabulary, v, device)


def problem_from_jax(p, device=None) -> BAProblem:
    return from_jax(BAProblem, p, device)


def window_from_jax(w, device=None) -> LocalBAWindow:
    return from_jax(LocalBAWindow, w, device)


def engine_state_from_jax(st, device=None) -> EngineState:
    """Every field of the JAX ``EngineState`` except ``key``."""
    return from_jax(EngineState, st, device)


def calibration_from_jax(cal, device=None) -> CameraCalibration:
    return CameraCalibration(
        float(np.float32(cal.fx)), float(np.float32(cal.fy)),
        float(np.float32(cal.cx)), float(np.float32(cal.cy)),
        tensor_from_numpy(np.asarray(cal.dist, np.float32), device),
        int(np.asarray(cal.model)), int(cal.width), int(cal.height))


def to_numpy(obj):
    """Port container -> dict of numpy arrays (nested containers become
    nested dicts); descriptor words come back as uint32."""
    out = {}
    for name in obj._fields:
        leaf = getattr(obj, name)
        if isinstance(leaf, tuple) and hasattr(leaf, "_fields"):
            out[name] = to_numpy(leaf)
        elif leaf is None:
            out[name] = None
        else:
            a = leaf.detach().cpu().numpy()
            out[name] = a.view(np.uint32) if name in UINT32_FIELDS else a
    return out
