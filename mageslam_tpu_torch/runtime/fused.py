"""Public facade of the fused engine: frames in, tracking results out.

Port of ``mageslam_tpu/runtime/fused.py`` (``MageSlamTPUFused``) with its
whole public surface: ``process_frame``, ``process_sequence``,
``process_stereo_frames``, ``flush``, ``result_for``,
``get_tracking_results_for_frames``, ``try_get_volume_of_interest``,
``add_sensor_sample`` / ``get_gravity_direction`` / ``get_scale``,
``reset``, ``fossilize``, map and loop counters; pose-prior providers,
mediator events, determinism checkpoints and drop-frame pacing.

Results resolve on the JAX facade's schedule.  Each step's (24,) output
row stays on the device in a queue; once ``fetch_every`` rows are queued
they are stacked and copied into pinned host memory without blocking (a
CUDA event marks the copy's end), and the window copied at the previous
drain is materialized: its results are recorded and the determinism
checkpoints, mediator events, prior-provider updates and fuser fences fire
for its frames, in frame order.  ``process_frame`` therefore returns the
frame's result if it has resolved and a ``SKIPPED`` placeholder otherwise;
``flush``, ``result_for`` and the trajectory queries resolve everything.
The pacing probe's default counts queued rows whose step has not finished
on the device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mageslam_tpu_torch.config import MageSlamSettings
from mageslam_tpu_torch.geometry import se3
from mageslam_tpu_torch.geometry.camera import CameraCalibration
from mageslam_tpu_torch.mapping import global_ba
from mageslam_tpu_torch.ops import pyramid
from mageslam_tpu_torch.ops.undistort import ImageRectifier
from mageslam_tpu_torch.runtime import device_engine as de
from mageslam_tpu_torch.runtime.facade_common import (
    SensorFacadeMixin, seed_map_from_stereo, tracking_results_from_history,
    volume_of_interest_from_map)
from mageslam_tpu_torch.runtime.fossilized import FossilizedMap
from mageslam_tpu_torch.runtime.results import TrackingResult, TrackingState
from mageslam_tpu_torch.tracking import stereo
from mageslam_tpu_torch.tracking.frontend import extract_for_settings
from mageslam_tpu_torch.utils.mediator import (AnalysisCompleted, Mediator,
                                               PoseRefined, TrackingLost)
from mageslam_tpu_torch.utils.tracing import PROFILER

_CODE_TO_STATE = {
    de.CODE_SKIPPED: TrackingState.SKIPPED,
    de.CODE_INITIALIZING: TrackingState.INITIALIZING,
    de.CODE_TRACKING: TrackingState.TRACKING,
    de.CODE_RELOCALIZING: TrackingState.RELOCALIZING,
}

# (stream, slice of the output row) of the per-stage determinism
# checkpoints, after the whole row's "FusedEngine" stream: the row packs
# code, pose, counts and the stage fingerprints of device_engine.step
_DETERMINISM_STREAMS = (
    ("Frontend", slice(13, 15)), ("Mapping/kf_poses", 15),
    ("Mapping/points", 16), ("Mapping/assoc", 17), ("Mapping/ba", 18),
    ("Tracking/pose", slice(0, 8)), ("Tracking/inliers", 8),
    ("Tracking/assoc", 19), ("Scheduler", 20))


class MageSlamTorchFused(SensorFacadeMixin):
    """Fused-engine SLAM session on one device.

    Results resolve within ``fetch_every`` frames (``flush`` resolves them
    at once).  ``pose_prior_provider`` (``tracking/pose_priors.py``) is
    asked for each frame's prior and told each tracked pose; ``busy_fn``
    overrides the drop-frame pacing probe; ``determinator``
    (``utils/determinism.py``) receives the checkpoint streams; events go
    to ``self.mediator``."""

    def __init__(self, settings: MageSlamSettings,
                 calibration: CameraCalibration, seed: int = 0,
                 fetch_every: int = 8, device=None, sampler_factory=None,
                 pose_prior_provider=None, busy_fn=None,
                 determinator=None):
        self.settings = settings
        self.device = de.resolve_device(device)
        if self.device.type == "cuda":
            # full float32 products (the solvers' normal equations); this
            # is PyTorch's default, stated here because the port relies
            # on it
            torch.backends.cuda.matmul.allow_tf32 = False
        self.engine = de.DeviceEngine(settings, calibration, self.device,
                                      seed=seed,
                                      sampler_factory=sampler_factory)
        self.cal = self.engine.cal
        self.mediator = Mediator()
        self.determinator = determinator
        self._prior_provider = pose_prior_provider
        self._busy_fn = busy_fn if busy_fn is not None else \
            self._pipeline_depth
        # the remap grid of stereo initialization's rectified frontend
        self._rectifier = ImageRectifier(self.cal)
        self._state = self.engine.empty_state()
        self._fetch_every = max(1, fetch_every)
        self._pending: list = []      # [(fid, ts, device row, step event)]
        self._inflight = None         # (meta, host rows, copy event)
        self._results: dict = {}
        self._rows: dict = {}
        self._frame_id = 0
        self._held = None             # (fid, ts, image, prior)
        self._dropped = 0

    # ------------------------------------------------------------------
    def reset(self, seed: int = 0):
        """Fresh SLAM session on the same engine (settings, calibration,
        device and built kernels are kept)."""
        self.engine.gen.manual_seed(seed)
        self._state = self.engine.empty_state()
        self._pending.clear()
        self._inflight = None
        self._results = {}
        self._rows = {}
        self._frame_id = 0
        self._held = None
        self._dropped = 0

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        img = torch.as_tensor(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            img = img.pin_memory().to(self.device, non_blocking=True)
        return img

    def _event(self):
        """A CUDA event recorded on the current stream (None on the CPU,
        where every queued operation has finished when it returns)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def _pipeline_depth(self) -> int:
        """Queued output rows whose step has not finished on the device."""
        return sum(ev is not None and not ev.query()
                   for _, _, _, ev in self._pending)

    def _next_frame(self, timestamp):
        fid = self._frame_id
        self._frame_id += 1
        ts = timestamp if timestamp is not None else fid / 30.0
        prior = None
        if self._prior_provider is not None:
            prior = self._prior_provider.get_pose_for_time(ts)
        return fid, ts, prior

    def process_frame(self, img, timestamp: Optional[float] = None
                      ) -> TrackingResult:
        """Run one engine step on a uint8 (H, W) or (H, W, 3) frame.

        With ``drop_frames_when_busy``, while ``busy_fn()`` reaches
        ``max_pipeline_depth`` the frame is held instead (an older held
        frame is dropped as SKIPPED) and dispatched before the next frame
        that finds the pipeline free (Runtime.cpp:107-121)."""
        fid, ts, prior = self._next_frame(timestamp)
        frame = self._upload(img)
        rt = self.settings.runtime
        if rt.drop_frames_when_busy:
            if self._busy_fn() >= rt.max_pipeline_depth:
                if self._held is not None:
                    hfid, hts, _, _ = self._held
                    self._results[hfid] = TrackingResult(
                        hfid, hts, TrackingState.SKIPPED)
                    self._dropped += 1
                self._held = (fid, ts, frame, prior)
                return TrackingResult(fid, ts, TrackingState.SKIPPED)
            self._dispatch_held()
        self._dispatch(fid, ts, frame, prior)
        return self._results.get(
            fid, TrackingResult(fid, ts, TrackingState.SKIPPED))

    def _dispatch_held(self):
        if self._held is not None:
            held, self._held = self._held, None
            self._dispatch(*held)

    @property
    def frames_dropped(self) -> int:
        """Frames discarded by drop-frame pacing."""
        return self._dropped

    def process_sequence(self, imgs, timestamps=None, chunk: int = 8):
        """File-driven processing: frames are uploaded ``chunk`` at a time
        (one host-to-device copy per batch) and stepped one by one; results
        are those of ``process_frame``.  Pacing does not apply."""
        n = len(imgs)
        for a in range(0, n, chunk):
            b = min(a + chunk, n)
            batch = self._upload(np.stack([np.asarray(im)
                                           for im in imgs[a:b]]))
            for j in range(b - a):
                fid, ts, prior = self._next_frame(
                    timestamps[a + j] if timestamps is not None else None)
                self._dispatch(fid, ts, batch[j], prior)

    def _dispatch(self, fid, ts, img: torch.Tensor, prior) -> None:
        with PROFILER.scope("frame", frame=fid):
            self._state, out = self.engine.step(self._state, img, float(ts),
                                                fid, ext_prior=prior)
            self._pending.append((fid, ts, out, self._event()))
            if len(self._pending) >= self._fetch_every:
                self._drain()

    def _drain(self, final: bool = False) -> None:
        """Start the host copy of the queued rows as one window and
        materialize the window copied at the previous drain; ``final``
        materializes the new window too."""
        if self._pending:
            stacked = torch.stack([o for _, _, o, _ in self._pending])
            meta = [(fid, ts) for fid, ts, _, _ in self._pending]
            self._pending.clear()
            if stacked.device.type == "cuda":
                host = torch.empty(stacked.shape, dtype=stacked.dtype,
                                   pin_memory=True)
                host.copy_(stacked, non_blocking=True)
                window = (meta, host, self._event())
            else:
                window = (meta, stacked, None)
            if self._inflight is not None:
                self._materialize_window(self._inflight)
            self._inflight = window
        if final and self._inflight is not None:
            window, self._inflight = self._inflight, None
            self._materialize_window(window)

    def _materialize_window(self, window) -> None:
        meta, host, copied = window
        if copied is not None:
            with PROFILER.scope("sync"):
                copied.synchronize()
        for (fid, ts), row in zip(meta, host.numpy()):
            self._materialize(fid, ts, row.copy())

    def _materialize(self, fid: int, ts: float, row: np.ndarray) -> None:
        """Record a frame's output row and fire what hangs on it:
        determinism checkpoints, mediator events, the prior provider's
        update and the fuser's fence."""
        self._rows[fid] = row
        if self.determinator is not None:
            self.determinator.check("FusedEngine", fid, row)
            for name, part in _DETERMINISM_STREAMS:
                self.determinator.check(name, fid, row[part])
        state = _CODE_TO_STATE.get(int(row[0]), TrackingState.SKIPPED)
        pose = row[1:8].copy() if state == TrackingState.TRACKING else None
        res = TrackingResult(fid, ts, state, pose)
        self._results[fid] = res
        self.mediator.send(AnalysisCompleted(fid, int(row[13])))
        if state == TrackingState.TRACKING:
            if self._prior_provider is not None:
                self._prior_provider.on_tracking_pose(ts, pose)
            self.mediator.send(PoseRefined(
                fid, pose, is_keyframe=bool(row[12] > 0),
                num_inliers=int(row[8])))
        elif state == TrackingState.RELOCALIZING:
            self.mediator.send(TrackingLost(fid, 0))
        self._drive_fuser(ts, res)

    def flush(self) -> dict:
        """Dispatch a frame held by pacing and resolve every result."""
        self._dispatch_held()
        self._drain(final=True)
        return self._results

    def result_for(self, fid: int) -> Optional[TrackingResult]:
        if fid not in self._results:
            self._drain(final=True)
        return self._results.get(fid)

    def get_tracking_results_for_frames(self, frame_ids):
        """Per-frame poses re-read from the pose history, so they reflect
        all later optimization (bundle adjustment, loop closure)."""
        self._drain(final=True)
        st = self._state
        return tracking_results_from_history(
            st.history, st.map.kf_pose, st.map.kf_valid, self._results,
            frame_ids)

    # ------------------------------------------------------------------
    def process_stereo_frames(self, img1, img2, extrinsics,
                              timestamp: Optional[float] = None):
        """MAGESlam::ProcessStereoFrames (MageSlam.h:156): bootstrap a
        metric map from one calibrated pair, then track monocularly on the
        primary camera.  ``extrinsics`` (7,) maps camera-1 coordinates to
        camera-2 coordinates.  Returns the (primary, secondary) results."""
        if bool(self._state.initialized):
            r1 = self.process_frame(img1, timestamp)
            r2 = TrackingResult(r1.frame_id, r1.timestamp, r1.state,
                                None if r1.pose is None else se3.pose_compose(
                                    torch.as_tensor(np.asarray(
                                        extrinsics, np.float32)),
                                    torch.as_tensor(r1.pose)).numpy())
            return r1, r2
        fid = self._frame_id
        self._frame_id += 1
        ts = timestamp if timestamp is not None else fid / 30.0
        s = self.settings
        F = s.capacity.max_features
        feats = [extract_for_settings(
            pyramid.to_gray_f32(self._upload(img)), self.cal, s.mono.camera,
            F, rectifier=self._rectifier) for img in (img1, img2)]
        extr = torch.as_tensor(np.asarray(extrinsics, np.float32),
                               device=self.device)
        res = stereo.stereo_initialize(feats[0], feats[1], extr,
                                       s.stereo.map_init, float(self.cal.fx))
        if not bool(res.success):
            r = TrackingResult(fid, ts, TrackingState.INITIALIZING)
            self._results[fid] = r
            return r, r
        st = self._state
        m, h, s0, _ = seed_map_from_stereo(st.map, st.history, feats[0],
                                           feats[1], res, extrinsics, fid, ts)
        self.engine.counts["keyframes_inserted"] += 2
        dev = self.device
        ident = se3.pose_identity(dev)
        self._state = st._replace(
            map=m, history=h, initialized=de._b(True, dev),
            pose_prev=ident, pose_prev2=ident.clone(),
            last_kf=s0.to(torch.int32), frames_since_kf=de._i32(0, dev))
        r1 = TrackingResult(fid, ts, TrackingState.TRACKING,
                            se3.pose_identity().numpy())
        r2 = TrackingResult(fid, ts, TrackingState.TRACKING,
                            np.asarray(extrinsics, np.float32))
        self._results[fid] = r1
        return r1, r2

    def try_get_volume_of_interest(self):
        """MAGESlam::TryGetVolumeOfInterest (MageSlam.h:178): the observed
        scene's box once mapping has settled, or None."""
        self._settle()
        return volume_of_interest_from_map(self._state.map, self.cal,
                                           self.settings)

    def output_row(self, fid: int) -> Optional[np.ndarray]:
        """The engine's packed (24,) output row of a frame (resolving the
        queued rows if it is not back yet)."""
        if fid not in self._rows:
            self._drain(final=True)
        return self._rows.get(fid)

    @property
    def host_syncs(self) -> int:
        return self.engine.host_syncs

    @property
    def state(self) -> de.EngineState:
        return self._state

    @state.setter
    def state(self, st: de.EngineState) -> None:
        self._state = st

    @property
    def map_state(self):
        return self._state.map

    @property
    def num_keyframes(self) -> int:
        return int(self._state.map.kf_valid.sum())

    @property
    def num_map_points(self) -> int:
        return int(self._state.map.mp_valid.sum())

    @property
    def loops_closed(self) -> int:
        return int(self._state.loops_closed)

    @property
    def cheap_loop_associations(self) -> int:
        """Associations installed by cheap loop closure so far."""
        return int(self.engine.cheap_loop_associations)

    def _settle(self):
        self._state = self.engine.drain_mapping(self._state)

    def fossilize(self) -> FossilizedMap:
        """Finish pending mapping, run global BA to its error floor, and
        return the immutable trajectory + map."""
        self._dispatch_held()
        self._drain(final=True)
        self._settle()
        s = self.settings
        if bool(self._state.initialized):
            chunk = max(int(s.graph_optimization.num_steps), 10)
            m, _ = global_ba.global_ba_to_floor(
                self._state.map, s, float(self.cal.fx),
                lam0=self._state.lam, chunk_steps=chunk)
            self._state = self._state._replace(map=m)
        return FossilizedMap.from_state(self._state.map, self._state.history)
