"""Session capture / replay: versioned binary streams + JSON manifest.

A copy of ``mageslam_tpu/io/recording.py`` (it holds no JAX) over the
port's ``fuser/samples.SensorSample``.  The format on disk is the JAX
package's byte for byte, so a recording written by either package replays
in the other.

Equivalent of the reference's Arcana "bob" recording subsystem
(Dependencies/Arcana/Shared/arcana/bob/bob.h, bob_data.h:28-39: versioned
binary stream files enumerated by a JSON manifest, used for sensor
capture/replay), combined with the SensorSampleQueue replay semantics
(Dependencies/FuserLib/Include/SensorSampleQueue.h:19 — timestamp-ordered
merge of IMU and image-fence events).

A ``Recording`` is a directory:

    manifest.json          {"version", "created", "streams": [{name, kind,
                            dtype, shape, count, file, version}, ...],
                            "metadata": {...}}
    <stream>.bin           raw little-endian records, fixed record shape

Streams are append-only during capture and memory-mapped on replay.
``replay()`` yields (timestamp, stream_name, record) across ALL streams in
global timestamp order — exactly what a SLAM session needs to re-feed
frames + IMU samples deterministically (the determinism harness,
utils/determinism.py, hashes the downstream pipeline to compare runs).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

MANIFEST_VERSION = 1


@dataclass
class _Stream:
    name: str
    kind: str                 # "frames" | "imu" | custom
    dtype: np.dtype
    shape: Tuple[int, ...]    # per-record shape (excluding leading count)
    version: int
    fh: Any = None
    count: int = 0


class RecordingWriter:
    """Append-only capture session. Each record carries a float64 timestamp
    prepended to the payload; payloads are fixed-shape per stream."""

    def __init__(self, path: str, metadata: Optional[dict] = None):
        self.root = Path(path)
        self.root.mkdir(parents=True, exist_ok=True)
        self._streams: Dict[str, _Stream] = {}
        self._metadata = dict(metadata or {})
        self._closed = False

    def add_stream(self, name: str, kind: str, dtype, shape,
                   version: int = 1):
        if name in self._streams:
            raise ValueError(f"duplicate stream {name!r}")
        s = _Stream(name, kind, np.dtype(dtype), tuple(shape), version)
        s.fh = open(self.root / f"{name}.bin", "wb")
        self._streams[name] = s
        return self

    def append(self, name: str, timestamp: float, record):
        s = self._streams[name]
        rec = np.ascontiguousarray(record, dtype=s.dtype)
        if rec.shape != s.shape:
            raise ValueError(
                f"stream {name!r}: record shape {rec.shape} != {s.shape}")
        s.fh.write(np.float64(timestamp).tobytes())
        s.fh.write(rec.tobytes())
        s.count += 1

    # convenience for the two standard streams --------------------------
    def add_frame_stream(self, height: int, width: int,
                         name: str = "frames"):
        return self.add_stream(name, "frames", np.uint8, (height, width))

    def add_imu_stream(self, name: str = "imu"):
        # record = [sample_type, x, y, z] (SensorSample.h:14-57)
        return self.add_stream(name, "imu", np.float32, (4,))

    def append_imu(self, timestamp: float, sample_type: int, xyz,
                   name: str = "imu"):
        rec = np.concatenate([[np.float32(sample_type)],
                              np.asarray(xyz, np.float32)])
        self.append(name, timestamp, rec)

    def close(self):
        if self._closed:
            return
        streams = []
        for s in self._streams.values():
            s.fh.close()
            streams.append({
                "name": s.name, "kind": s.kind, "dtype": s.dtype.str,
                "shape": list(s.shape), "count": s.count,
                "file": f"{s.name}.bin", "version": s.version,
            })
        manifest = {
            "version": MANIFEST_VERSION,
            "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "streams": streams,
            "metadata": self._metadata,
        }
        (self.root / "manifest.json").write_text(
            json.dumps(manifest, indent=2))
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@dataclass
class ReplayStream:
    name: str
    kind: str
    version: int
    timestamps: np.ndarray    # (N,)
    records: np.ndarray       # (N, *shape) memory-mapped view


class Recording:
    """Replay side: memory-mapped streams + global timestamp-ordered merge."""

    def __init__(self, path: str):
        self.root = Path(path)
        manifest = json.loads((self.root / "manifest.json").read_text())
        if manifest["version"] > MANIFEST_VERSION:
            raise ValueError(
                f"manifest version {manifest['version']} is newer than "
                f"supported {MANIFEST_VERSION}")
        self.metadata: dict = manifest.get("metadata", {})
        self.streams: Dict[str, ReplayStream] = {}
        for sm in manifest["streams"]:
            dtype = np.dtype(sm["dtype"])
            shape = tuple(sm["shape"])
            count = sm["count"]
            rec_bytes = int(dtype.itemsize * int(np.prod(shape or (1,))))
            raw = np.memmap(self.root / sm["file"], dtype=np.uint8,
                            mode="r", shape=(count, 8 + rec_bytes))
            ts = raw[:, :8].copy().view(np.float64)[:, 0]
            records = raw[:, 8:].view(dtype).reshape((count,) + shape)
            self.streams[sm["name"]] = ReplayStream(
                sm["name"], sm["kind"], sm["version"], ts, records)

    def replay(self, names: Optional[List[str]] = None
               ) -> Iterator[Tuple[float, str, np.ndarray]]:
        """Yield (timestamp, stream_name, record) in global timestamp order
        (stable: ties resolve by stream declaration order then index)."""
        names = names or list(self.streams)
        cursors = {n: 0 for n in names}
        while True:
            best = None
            for n in names:
                s = self.streams[n]
                i = cursors[n]
                if i >= len(s.timestamps):
                    continue
                t = float(s.timestamps[i])
                if best is None or t < best[0]:
                    best = (t, n, i)
            if best is None:
                return
            t, n, i = best
            cursors[n] = i + 1
            yield t, n, self.streams[n].records[i]

    def frames(self, name: str = "frames"):
        s = self.streams[name]
        for i in range(len(s.timestamps)):
            yield float(s.timestamps[i]), s.records[i]


def record_session(path: str, images, timestamps,
                   imu_samples=None, metadata: Optional[dict] = None):
    """One-call capture of a full session (images: iterable of (H, W)
    uint8)."""
    images = list(images)
    h, w = np.asarray(images[0]).shape[:2]
    with RecordingWriter(path, metadata) as wtr:
        wtr.add_frame_stream(h, w)
        if imu_samples:
            wtr.add_imu_stream()
            for s in imu_samples:
                wtr.append_imu(s.timestamp, int(s.sample_type), s.data)
        for ts, img in zip(timestamps, images):
            gray = np.asarray(img)
            if gray.ndim == 3:
                gray = gray.mean(-1)
            wtr.append("frames", float(ts), gray.astype(np.uint8))
    return path
