"""IMU sensor sample types and timestamp-ordered queue.

A copy of ``mageslam_tpu/fuser/samples.py`` (it holds no JAX).
Equivalent of FuserLib's sample plumbing (Dependencies/FuserLib/Include/
SensorSample.h:14-57: accel/gyro/mag samples + image-fence markers;
SensorSampleQueue.h:19: timestamp-ordered queue) feeding
MAGESlam::AddSensorSample (MageSlam.h:164).

Host-side (sensor ingestion is IO, not device compute): a simple sorted
buffer with image-fence extraction — samples up to a frame timestamp are
drained for integration.
"""

from __future__ import annotations

import bisect
import dataclasses
from enum import IntEnum
from typing import List, Optional

import numpy as np


class SampleType(IntEnum):  # SensorSample.h SampleType
    ACCELEROMETER = 0
    GYROSCOPE = 1
    MAGNETOMETER = 2
    IMAGE_FENCE = 3


@dataclasses.dataclass(frozen=True, order=True)
class SensorSample:
    timestamp: float
    sample_type: SampleType = dataclasses.field(compare=False)
    data: tuple = dataclasses.field(compare=False, default=())

    @staticmethod
    def accel(timestamp: float, xyz) -> "SensorSample":
        return SensorSample(timestamp, SampleType.ACCELEROMETER, tuple(xyz))

    @staticmethod
    def gyro(timestamp: float, xyz) -> "SensorSample":
        return SensorSample(timestamp, SampleType.GYROSCOPE, tuple(xyz))

    @staticmethod
    def mag(timestamp: float, xyz) -> "SensorSample":
        return SensorSample(timestamp, SampleType.MAGNETOMETER, tuple(xyz))


class SensorSampleQueue:
    """Timestamp-ordered insertion + drain-to-fence (SensorSampleQueue.h).

    drop_mag mirrors FuserSettings.DropMagSamples.
    """

    def __init__(self, drop_mag: bool = True, capacity: int = 10000):
        self._q: List[SensorSample] = []
        self._drop_mag = drop_mag
        self._capacity = capacity

    def add_sample(self, sample: SensorSample) -> bool:
        if self._drop_mag and sample.sample_type == SampleType.MAGNETOMETER:
            return False
        if len(self._q) >= self._capacity:
            self._q.pop(0)
        bisect.insort(self._q, sample)
        return True

    def drain_until(self, timestamp: float) -> List[SensorSample]:
        """Pop all samples with t <= timestamp (the image-fence drain)."""
        i = bisect.bisect_right(self._q,
                                SensorSample(timestamp, SampleType.IMAGE_FENCE))
        out, self._q = self._q[:i], self._q[i:]
        return out

    def __len__(self):
        return len(self._q)

    def split_by_type(self, samples: List[SensorSample]):
        accel = np.asarray([(s.timestamp, *s.data) for s in samples
                            if s.sample_type == SampleType.ACCELEROMETER]
                           or np.zeros((0, 4)))
        gyro = np.asarray([(s.timestamp, *s.data) for s in samples
                           if s.sample_type == SampleType.GYROSCOPE]
                          or np.zeros((0, 4)))
        return accel, gyro
