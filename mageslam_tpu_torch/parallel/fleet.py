"""A fleet of independent SLAM sessions: one video stream per device slot.

Port of ``mageslam_tpu/parallel/fleet.py``.  The JAX fleet runs one stream
per mesh device under one ``shard_map``'d step.  Here the "mesh" is a list
of devices, one per session (several may name the same card), and each
session is a ``DeviceEngine`` with its own ``EngineState`` on its device.
``process_frames`` steps the streams in index order; their output rows
stay on the device and are copied to the host together at ``flush``, on
the JAX fleet's schedule (every ``fetch_every`` frames).  The sessions are
not batched into one program: the engine's step is host-orchestrated (its
branches are Python ``if``s on device values), so each stream keeps its
own branch choices, as the JAX fleet's ``shard_map`` keeps real
``lax.cond`` branches per device.

Each stream draws from its own generator, seeded by
``stream_seed(seed, i)``: the first 32-bit word of numpy's
``SeedSequence((seed, i))``, distinct per stream and the same on every
run.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from mageslam_tpu_torch.config import MageSlamSettings
from mageslam_tpu_torch.geometry.camera import CameraCalibration
from mageslam_tpu_torch.runtime import device_engine as de
from mageslam_tpu_torch.runtime.devices import resolve_device


def default_mesh(n: Optional[int] = None) -> list:
    """``n`` session devices (default: one per visible card), cycling over
    the visible cards: ``["cuda:0"] * n`` on one card.  Raises without a
    card, like every entry point."""
    resolve_device(None)
    cards = [torch.device(f"cuda:{i}")
             for i in range(torch.cuda.device_count())]
    n = n or len(cards)
    return [cards[i % len(cards)] for i in range(n)]


def stream_seed(seed: int, i: int) -> int:
    """Stream ``i``'s generator seed: the first 32-bit word of
    ``np.random.SeedSequence((seed, i))``."""
    return int(np.random.SeedSequence((seed, i)).generate_state(1)[0])


class SlamFleet:
    """N independent SLAM streams, one per entry of ``mesh``.

    ``process_frames(imgs (N, H, W))`` runs one engine step per stream;
    results resolve in batches like ``MageSlamTorchFused``'s."""

    def __init__(self, settings: MageSlamSettings,
                 calibration: CameraCalibration,
                 mesh: Optional[Sequence] = None, seed: int = 0):
        self.settings = settings
        self.mesh = [torch.device(d) for d in
                     (mesh if mesh is not None else default_mesh())]
        self.n_streams = len(self.mesh)
        self.engines = [de.DeviceEngine(settings, calibration, dev,
                                        seed=stream_seed(seed, i))
                        for i, dev in enumerate(self.mesh)]
        self.cal = calibration
        self._states = [e.empty_state() for e in self.engines]
        self._frame = 0
        self._pending: list = []
        self._results: dict[int, np.ndarray] = {}

    # ------------------------------------------------------------------
    def _upload(self, imgs) -> dict:
        """The frames on each distinct device of the mesh (one copy per
        device)."""
        host = torch.as_tensor(np.ascontiguousarray(imgs)) \
            if not torch.is_tensor(imgs) else imgs
        out = {}
        for dev in dict.fromkeys(self.mesh):
            if host.device == dev:
                out[dev] = host
            elif dev.type == "cuda" and host.device.type == "cpu":
                out[dev] = host.pin_memory().to(dev, non_blocking=True)
            else:
                out[dev] = host.to(dev)
        return out

    def process_frames(self, imgs, timestamps=None, fetch_every: int = 8):
        """One frame per stream: imgs (N, H, W) uint8 or float."""
        fid = self._frame
        self._frame += 1
        ts = (np.full(self.n_streams, fid / 30.0, np.float32)
              if timestamps is None
              else np.asarray(timestamps, np.float32))
        frames = self._upload(imgs)
        outs = []
        for i, (eng, dev) in enumerate(zip(self.engines, self.mesh)):
            self._states[i], out = eng.step(self._states[i], frames[dev][i],
                                            float(ts[i]), fid)
            outs.append(out)
        self._pending.append((fid, outs))
        if len(self._pending) >= fetch_every:
            self.flush()
        return fid

    def flush(self):
        for fid, outs in self._pending:
            self._results[fid] = np.stack([o.cpu().numpy() for o in outs])
        self._pending.clear()
        return self._results

    # ------------------------------------------------------------------
    def stream_state(self, i: int) -> de.EngineState:
        """Stream i's EngineState (on its device)."""
        return self._states[i]

    @property
    def num_keyframes(self) -> np.ndarray:
        return np.array([int(st.map.kf_valid.sum()) for st in self._states])

    @property
    def num_map_points(self) -> np.ndarray:
        return np.array([int(st.map.mp_valid.sum()) for st in self._states])

    def codes(self, fid: int) -> np.ndarray:
        """(N,) tracking state codes for frame fid (after flush)."""
        return self._results[fid][:, 0].astype(np.int32)

    def poses(self, fid: int) -> np.ndarray:
        return self._results[fid][:, 1:8]
