"""A copy of ``mageslam_tpu/utils/determinism.py`` (it holds no JAX);
``value_hash`` also takes torch tensors, on any device.

Determinism harness: hash pipeline intermediates, record/replay compare.

Equivalent of the reference's determinator system (Dependencies/Arcana/
Shared/arcana/analysis/determinator.h:16-110: DETERMINISTIC_CHECK CRC32-
hashes intermediate values at ~40 checkpoints per thread into named
streams; saved sample-vs-truth vectors enable record/replay regression
comparison — the reference's de-facto integration test, SURVEY.md §4).

Here: named channels of checkpoint hashes per frame; hashes are CRC32 of
the raw bytes of (batches of) arrays fetched from device.  ``save`` /
``load`` + ``compare`` reproduce the record/replay workflow.
"""

from __future__ import annotations

import json
import zlib
from collections import defaultdict
from typing import Any

import numpy as np
import torch


def to_host(v: Any) -> Any:
    """A torch tensor as a numpy array on the host (its dtype kept); any
    other value as it is."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return v


def value_hash(*values: Any) -> int:
    """CRC32 over the concatenated bytes of the values (order-sensitive).
    A tensor hashes as the numpy array of its values, so equal values of
    equal dtype and shape hash alike in both packages."""
    crc = 0
    for v in values:
        a = np.asarray(to_host(v))
        crc = zlib.crc32(a.tobytes(), crc)
        crc = zlib.crc32(str(a.shape).encode(), crc)
    return crc & 0xFFFFFFFF


class Determinator:
    """Named per-channel checkpoint streams (arcana determinator analog).

    Usage:
        det = Determinator()
        det.check("TrackingThread", pose, inliers)   # per checkpoint
        det.save("run.json")
        truth = Determinator.load("run.json")
        diffs = det.compare(truth)
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._streams: dict[str, list[int]] = defaultdict(list)

    def check(self, channel: str, *values: Any) -> int | None:
        if not self.enabled:
            return None
        h = value_hash(*values)
        self._streams[channel].append(h)
        return h

    @property
    def streams(self) -> dict[str, list[int]]:
        return dict(self._streams)

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self._streams, f)

    @staticmethod
    def load(path: str) -> "Determinator":
        det = Determinator()
        with open(path) as f:
            det._streams = defaultdict(list, json.load(f))
        return det

    def compare(self, truth: "Determinator") -> dict[str, int]:
        """Per channel: index of the first divergent checkpoint (-1 if the
        streams agree; length mismatches count as divergence)."""
        out = {}
        channels = set(self._streams) | set(truth._streams)
        for ch in channels:
            a = self._streams.get(ch, [])
            b = truth._streams.get(ch, [])
            first = -1
            for i, (x, y) in enumerate(zip(a, b)):
                if x != y:
                    first = i
                    break
            if first < 0 and len(a) != len(b):
                first = min(len(a), len(b))
            out[ch] = first
        return out

    def reset(self):
        self._streams.clear()
