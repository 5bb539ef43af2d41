"""Function I/O capture (xray) + dataflow hashing (DataFlow).

Equivalents of:
- Arcana ``xray`` (Dependencies/Arcana/Shared/arcana/analysis/xray.h:28-43):
  capture a function's inputs and outputs to JSON for offline inspection
  (used at e.g. ThreadSafeMap.cpp:1055-1060 around keyframe culling).
- ``DataFlow`` (Core/MAGESLAM/Source/Analysis/DataFlow.h:14-60): declare a
  worker's inputs/outputs and hash them, producing a per-stage dataflow
  fingerprint for divergence hunting.

Port of ``mageslam_tpu/utils/xray.py``.  Values are nested containers of
tensors (on any device) or arrays; capture moves them to the host (small:
poses, counts, index vectors, not images) and serializes shapes, dtypes
and data.  A tensor is written as the numpy array of its values, so equal
values give equal JSON in both packages.  Hashing reuses the port's
``utils/determinism.value_hash``, so a port run's ``DataFlowLog`` and a
JAX run's compare with ``first_divergence``.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from mageslam_tpu_torch.utils.determinism import to_host, value_hash


def _to_jsonable(v: Any, max_elems: int = 4096) -> Any:
    """Array or tensor -> {shape, dtype, data|hash}; containers recurse
    (a NamedTuple as the tuple it is, as in the JAX package); scalars
    pass."""
    if isinstance(v, dict):
        return {str(k): _to_jsonable(x, max_elems) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        out = [_to_jsonable(x, max_elems) for x in v]
        return out if isinstance(v, list) else {"tuple": out}
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    a = np.asarray(to_host(v))
    entry: Dict[str, Any] = {"shape": list(a.shape), "dtype": str(a.dtype)}
    if a.size <= max_elems:
        entry["data"] = a.tolist()
    else:
        entry["crc32"] = value_hash(a)
    return entry


class Xray:
    """Collects (name, inputs, outputs) capture records; dumps to JSON."""

    def __init__(self, enabled: bool = True, max_elems: int = 4096):
        self.enabled = enabled
        self.max_elems = max_elems
        self.records: List[dict] = []

    def capture(self, name: str, inputs: Any, outputs: Any):
        if not self.enabled:
            return
        self.records.append({
            "name": name,
            "inputs": _to_jsonable(inputs, self.max_elems),
            "outputs": _to_jsonable(outputs, self.max_elems),
        })

    def wrap(self, name: Optional[str] = None) -> Callable:
        """Decorator: records every call's args/result (xray.h XRAY usage)."""
        def deco(fn):
            label = name or fn.__name__

            @functools.wraps(fn)
            def inner(*args, **kwargs):
                out = fn(*args, **kwargs)
                self.capture(label,
                             {"args": list(args), "kwargs": kwargs}, out)
                return out
            return inner
        return deco

    def save(self, path: str):
        Path(path).write_text(json.dumps(self.records, indent=1))

    def reset(self):
        self.records.clear()


class DataFlow:
    """Per-stage input/output fingerprints (Analysis/DataFlow.h:14-60).

    Usage per pipeline stage:
        flow = DataFlow("MappingStep")
        flow.input(new_kf_pose, assoc)
        ... run stage ...
        flow.output(map_after.kf_pose, map_after.mp_pos)
        print(flow.fingerprint())   # {"stage", "in", "out"}
    """

    def __init__(self, stage: str):
        self.stage = stage
        self._in: List[int] = []
        self._out: List[int] = []

    def input(self, *values: Any) -> "DataFlow":
        self._in.append(value_hash(*values))
        return self

    def output(self, *values: Any) -> "DataFlow":
        self._out.append(value_hash(*values))
        return self

    def fingerprint(self) -> dict:
        return {"stage": self.stage,
                "in": value_hash(np.asarray(self._in, np.uint32)),
                "out": value_hash(np.asarray(self._out, np.uint32))}


class DataFlowLog:
    """Accumulates stage fingerprints across a run; compare two runs to
    localize the first diverging stage (the reference's divergence-hunting
    workflow, fed from worker inputs/outputs)."""

    def __init__(self):
        self.entries: List[dict] = []

    def add(self, flow: DataFlow):
        self.entries.append(flow.fingerprint())

    def save(self, path: str):
        Path(path).write_text(json.dumps(self.entries, indent=1))

    @staticmethod
    def load(path: str) -> "DataFlowLog":
        log = DataFlowLog()
        log.entries = json.loads(Path(path).read_text())
        return log

    def first_divergence(self, other: "DataFlowLog") -> Optional[int]:
        """Index of the first differing fingerprint (None if identical up to
        the shorter log's length and lengths match)."""
        for i, (a, b) in enumerate(zip(self.entries, other.entries)):
            if a != b:
                return i
        if len(self.entries) != len(other.entries):
            return min(len(self.entries), len(other.entries))
        return None
