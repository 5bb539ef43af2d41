"""Carry settings and state across from the JAX package, and back to numpy.

The JAX package's containers (``FrameFeatures``, ``MapState``,
``PoseHistory``, ``Vocabulary``, ``BAProblem``, ``LocalBAWindow``,
``EngineState``, ``BowDatabase``, ``LoopDetection``, ``SpanningTree``,
``EssentialGraph``, ``PoseGraphProblem``, ``StereoInitResult``) have
counterparts here with the same field names, shapes and dtypes, so
conversion is field by field.  ``VolumeOfInterest`` holds numpy arrays on
both sides, and the fuser is host state (``fuser_from_jax``).  The JAX side
is read as numpy arrays (``np.asarray`` of each leaf — this module never
imports jax); 32-bit unsigned descriptor words are viewed as ``int32``
with the same bits.

Settings cross as JSON text (``settings_from_jax``), so no class of the
JAX package is touched here.

``EngineState.key`` is not carried: ``jax.random`` keys and
``torch.Generator`` states have no common meaning, so the port's engine
draws from its own generator.  While tracking holds the engine draws
nothing, which is why a carried state steps identically in both engines;
relocalization and loop detection draw through a sampler that a test can
replace (``DeviceEngine(sampler_factory=...)``).
"""

from __future__ import annotations

import types

import numpy as np
import torch

from mageslam_tpu_torch.bow.database import BowDatabase
from mageslam_tpu_torch.bow.vocab import Vocabulary
from mageslam_tpu_torch.config import MageSlamSettings
from mageslam_tpu_torch.fuser.imu import Fuser, FuserMode, UnfilteredIMU
from mageslam_tpu_torch.geometry.camera import CameraCalibration
from mageslam_tpu_torch.loop.closure import LoopDetection
from mageslam_tpu_torch.mapping.local_ba import LocalBAWindow
from mageslam_tpu_torch.mapstore.map_state import MapState
from mageslam_tpu_torch.mapstore.pose_history import PoseHistory
from mageslam_tpu_torch.mapstore.spanning_tree import (EssentialGraph,
                                                       SpanningTree)
from mageslam_tpu_torch.mapstore.volume_of_interest import VolumeOfInterest
from mageslam_tpu_torch.runtime.device_engine import EngineState
from mageslam_tpu_torch.solvers.bundle_adjust import BAProblem
from mageslam_tpu_torch.solvers.pose_graph import PoseGraphProblem
from mageslam_tpu_torch.tracking.frontend import FrameFeatures
from mageslam_tpu_torch.tracking.stereo import StereoInitResult

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
    return cls(**vals)


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


def database_from_jax(db, device=None) -> BowDatabase:
    return from_jax(BowDatabase, db, device)


def loop_detection_from_jax(det, device=None) -> LoopDetection:
    return from_jax(LoopDetection, det, device)


def spanning_tree_from_jax(tree, device=None) -> SpanningTree:
    return from_jax(SpanningTree, tree, device)


def essential_graph_from_jax(eg, device=None) -> EssentialGraph:
    return from_jax(EssentialGraph, eg, device)


def pose_graph_problem_from_jax(p, device=None) -> PoseGraphProblem:
    return from_jax(PoseGraphProblem, p, device)


def stereo_result_from_jax(r, device=None) -> StereoInitResult:
    return from_jax(StereoInitResult, r, device)


def volume_of_interest_from_jax(v) -> VolumeOfInterest:
    return VolumeOfInterest(np.asarray(v.min_corner),
                            np.asarray(v.max_corner), bool(v.valid))


def fuser_from_jax(f) -> Fuser:
    """A port ``Fuser`` in the state of a JAX-package one: mode, gravity
    and scale accumulators, the integrator and the last visual pose."""
    out = Fuser(f._grav_needed, f._scale_needed)
    out.mode = FuserMode(int(f.mode))
    out._grav_accum = np.array(f._grav_accum, copy=True)
    out._grav_count = int(f._grav_count)
    out._scale_num, out._scale_den = float(f._scale_num), \
        float(f._scale_den)
    out._scale_windows = int(f._scale_windows)
    out._imu = UnfilteredIMU(np.array(f._imu.q_wb, copy=True),
                             np.array(f._imu.v, copy=True),
                             np.array(f._imu.gravity_w, copy=True))
    last = f._last_visual_pose
    out._last_visual_pose = None if last is None else np.array(last)
    return out


def engine_state_from_jax(st, device=None) -> EngineState:
    """Every field of the JAX ``EngineState`` except ``key``."""
    return from_jax(EngineState, st, device)


def _namespace_from_npz(z, prefix: str) -> types.SimpleNamespace:
    """The leaves stored under ``prefix`` + a slash-joined field path
    (``map/kf_pose``), as the fixture tools write them, as a namespace
    tree."""
    root = types.SimpleNamespace()
    for key in z.files:
        if not key.startswith(prefix):
            continue
        *parents, leaf = key[len(prefix):].split("/")
        node = root
        for name in parents:
            if not hasattr(node, name):
                setattr(node, name, types.SimpleNamespace())
            node = getattr(node, name)
        setattr(node, leaf, z[key])
    return root


def engine_state_from_npz(z, prefix: str, device=None) -> EngineState:
    """An ``EngineState`` from an ``.npz`` that holds each leaf of a JAX
    one under ``prefix`` + its slash-joined field path (``map/kf_pose``),
    as the fixture tools write them."""
    return engine_state_from_jax(_namespace_from_npz(z, prefix), device)


def map_from_npz(z, prefix: str = "map/", device=None) -> MapState:
    """A ``MapState`` from the leaves of a JAX one stored under ``prefix``
    + field name."""
    return map_from_jax(_namespace_from_npz(z, prefix), device)


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
