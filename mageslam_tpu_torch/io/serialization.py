"""Versioned checkpoints of engine state.

Port of ``mageslam_tpu/io/serialization.py``: any NamedTuple of tensors
(``EngineState``, ``MapState``, ...) goes to one compressed ``.npz`` with a
leaf per slash-joined field path (``map/kf_pose``) and the JSON metadata
under ``__meta__``, the JAX package's layout, so that a checkpoint written
by either package loads in the other.  Descriptor words are written as
``uint32`` (the JAX dtype; the port holds them as ``int32`` with the same
bits).

The port's ``EngineState`` has no PRNG key.  JAX's loader reads a ``key``
leaf whenever its template has one, so an ``EngineState`` checkpoint of the
port carries the key data of ``jax.random.key(0)``, two zero words: what a
fresh JAX engine starts from.  ``load_state`` ignores a ``key`` leaf, and a
field that an older checkpoint lacks keeps the template's value, as the
JAX loader does.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

from mageslam_tpu_torch.convert import UINT32_FIELDS
from mageslam_tpu_torch.runtime.device_engine import EngineState

FORMAT_VERSION = 2  # v2: MapState has mp_octave / mp_max_dist
# raw words of jax.random.key(0) (threefry2x32)
_DEFAULT_KEY_DATA = np.zeros(2, np.uint32)


def _flatten(prefix: str, obj: Any, out: dict) -> None:
    if hasattr(obj, "_fields"):
        for name in obj._fields:
            _flatten(f"{prefix}{name}/", getattr(obj, name), out)
        return
    key = prefix.rstrip("/")
    a = obj.detach().cpu().numpy() if torch.is_tensor(obj) \
        else np.asarray(obj)
    out[key] = a.view(np.uint32) if key.rsplit("/", 1)[-1] in \
        UINT32_FIELDS and a.dtype == np.int32 else a


def _unflatten(template: Any, prefix: str, data) -> Any:
    if hasattr(template, "_fields"):
        return type(template)(**{
            name: _unflatten(getattr(template, name), f"{prefix}{name}/",
                             data) for name in template._fields})
    key = prefix.rstrip("/")
    if key not in data.files:
        return template
    a = data[key]
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a).to(template.device, template.dtype)


def save_state(path: str, state: Any, metadata: dict | None = None) -> None:
    """Save a NamedTuple of tensors (``EngineState``, ``MapState``, ...)."""
    flat: dict = {}
    _flatten("", state, flat)
    if isinstance(state, EngineState):
        flat["key"] = _DEFAULT_KEY_DATA
    meta = {"format_version": FORMAT_VERSION, "type": type(state).__name__}
    if metadata:
        meta.update(metadata)
    flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(path, **flat)


def load_state(path: str, template: Any) -> Any:
    """Load into the structure, dtypes and devices of ``template``."""
    data = np.load(path)
    meta = json.loads(bytes(data["__meta__"]).decode())
    if meta["format_version"] > FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format {meta['format_version']} is newer than "
            f"supported {FORMAT_VERSION}")
    return _unflatten(template, "", data)
