"""MageSlamTorch: the host-orchestrated engine (public facade + scheduler).

Port of ``mageslam_tpu/runtime/slam.py`` (``MageSlamTPU``), the JAX
package's second public engine beside the fused one: the reference's
public API and runtime orchestration (MageSlam.h:25-187, Runtime.cpp:
365-398 and :510-587, MappingWorker.cpp:147-372, the initialization
worker) as sequential host code over the port's module functions.  Every
frame runs the frontend, then initialization or tracking; a frame promoted
to keyframe runs the whole mapping pass (insert, cheap loop closure, point
culling, new points, two local-BA windows, keyframe culling, loop closure)
before ``process_frame`` returns.

It is host-orchestrated by design: each ``int()``, ``float()`` and
``bool()`` below is a device-to-host read, and the keyframe decision runs
on host arrays (``tracking/keyframe_decision.py``).  The fused engine
(``runtime/fused.py``) is the one that keeps such reads few.

Unlike the fused step, frames go through ``extract_for_settings``, which
rectifies the image when ``undistort_image_pixels`` is set (the JAX host
engine does the same; the fused step ignores the flag).

Randomness.  The JAX engine splits its PRNG key at four places:
initialization, vocabulary training, relocalization and loop detection.
Here each of those calls ``sampler_factory()`` once, at the same point,
and draws every minimal set of that attempt through the returned
``sampler(p, num, k)`` (``solvers/sampling.py``); the default draws from
the engine's ``torch.Generator``.  A test can so replay the JAX key chain.

Determinism checkpoints go to ``determinator`` on the JAX engine's
channels, in its order and with its values and dtypes, so equal values
give equal streams in both packages.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mageslam_tpu_torch.bow import database as bdb
from mageslam_tpu_torch.bow import vocab as bv
from mageslam_tpu_torch.config import MageSlamSettings
from mageslam_tpu_torch.geometry import se3
from mageslam_tpu_torch.geometry.camera import CameraCalibration
from mageslam_tpu_torch.loop import closure as loop_closure
from mageslam_tpu_torch.mapping import culling, global_ba, local_ba, new_points
from mageslam_tpu_torch.mapping.cheap_loop_closure import cheap_loop_closure
from mageslam_tpu_torch.mapstore import map_state as ms
from mageslam_tpu_torch.mapstore import pose_history as ph
from mageslam_tpu_torch.ops import pyramid, util
from mageslam_tpu_torch.ops.undistort import ImageRectifier
from mageslam_tpu_torch.runtime.device_engine import check_supported
from mageslam_tpu_torch.runtime.devices import resolve_device
from mageslam_tpu_torch.runtime.facade_common import (
    SensorFacadeMixin, seed_map_from_stereo, tracking_results_from_history,
    volume_of_interest_from_map)
from mageslam_tpu_torch.runtime.fossilized import FossilizedMap
from mageslam_tpu_torch.runtime.results import TrackingResult, TrackingState
from mageslam_tpu_torch.solvers import sampling
from mageslam_tpu_torch.solvers.bundle_adjust import bundle_adjust
from mageslam_tpu_torch.tracking import (initialization, keyframe_decision,
                                         relocalization, stereo, track)
from mageslam_tpu_torch.tracking.frontend import extract_for_settings
from mageslam_tpu_torch.tracking.keyframe_decision import (
    KeyframeDecisionInputs, should_add_keyframe)
from mageslam_tpu_torch.utils.mediator import (AnalysisCompleted,
                                               HistoryUpdated, InitCompleted,
                                               Mediator, PoseRefined,
                                               TrackingLost)

NUM_FIXED = 8


def _f32(v: float) -> float:
    """A Python number rounded to float32 (``jnp.float32(v)``)."""
    return float(np.float32(v))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


class MageSlamTorch(SensorFacadeMixin):
    """Monocular keyframe SLAM engine, host-orchestrated (MageSlam.h:25-187
    analog).  Runs on the card unless ``device`` names another device."""

    def __init__(self, settings: MageSlamSettings,
                 calibration: CameraCalibration, seed: int = 0,
                 device=None, sampler_factory=None,
                 pose_prior_provider=None, determinator=None):
        check_supported(settings)
        self.settings = settings
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # full float32 products (the solvers' normal equations); this
            # is PyTorch's default, stated here because the port relies
            # on it
            torch.backends.cuda.matmul.allow_tf32 = False
        self.cal = calibration.to(self.device)
        self.fx = float(calibration.fx)
        self.px = 1.0 / self.fx
        # determinism checkpoints (arcana determinator.h:16-21): per-frame
        # tracking hashes on "TrackingThread", per-commit mapping hashes
        # on "MappingThread", and every pipeline stage's own channel
        self.determinator = determinator
        self.mediator = Mediator()
        self._prior_provider = pose_prior_provider
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.sampler_factory = sampler_factory or (
            lambda: sampling.generator_sampler(self.gen))
        self._rectifier = ImageRectifier(self.cal)
        cap = settings.capacity
        self._map = self._empty_map()
        self._history = ph.empty_history(cap.pose_history_size, self.device)
        self._initialized = False
        self._frame_id = 0
        self._init_buffer: list = []    # [(frame_id, ts, feats)]
        self._pose_prev: Optional[torch.Tensor] = None
        self._pose_prev2: Optional[torch.Tensor] = None
        self._last_kf: int = 0
        self._frames_since_kf = 0
        self._frames_since_reloc = 10_000
        self._lost_count = 0
        self._lam = float(settings.mapping.min_lambda)
        self._covis_threshold = float(settings.covisibility
                                      .covis_min_threshold)
        self._results: dict[int, TrackingResult] = {}
        self._kf_frame_ids: list[int] = []
        # BoW: vocabulary trained online from the first TrainingFrames
        # frames' descriptors; tracking goes on while it accumulates
        self._bow = bdb.empty_database(cap.max_keyframes, self.device)
        self._bow_training: list = []
        self._bow_trained = False
        self._loops_closed = 0
        self._ba_converged = False   # last window reached its error floor
        self._init_probation = False  # third-frame confirmation pending
        self._init_points = 0

    def _empty_map(self) -> ms.MapState:
        cap = self.settings.capacity
        return ms.empty_map(cap.max_keyframes, cap.max_features,
                            cap.max_map_points, self.device)

    def _det(self, channel: str, fid, *values):
        """Determinism checkpoint (DETERMINISTIC_CHECK analog); a no-op
        without a determinator."""
        if self.determinator is not None:
            self.determinator.check(channel, fid, *values)

    def _upload(self, img) -> torch.Tensor:
        if torch.is_tensor(img):
            return img.to(self.device)
        return torch.as_tensor(np.ascontiguousarray(img)).to(self.device)

    def _extract(self, img):
        s = self.settings
        return extract_for_settings(
            pyramid.to_gray_f32(self._upload(img)), self.cal,
            s.mono.camera, s.capacity.max_features,
            rectifier=self._rectifier)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def process_frame(self, img, timestamp: Optional[float] = None
                      ) -> TrackingResult:
        """Track one frame (MAGESlam::ProcessFrame, MageSlam.h:150).

        img: (H, W) grayscale (uint8 or float) or (H, W, 3) BGR, a numpy
        array or a tensor."""
        fid = self._frame_id
        self._frame_id += 1
        ts = timestamp if timestamp is not None else fid / 30.0

        feats = self._extract(img)
        self._feed_bow_training(feats)
        self._det("Frontend", fid, _np(feats.uv), _np(feats.desc),
                  _np(feats.valid))
        self.mediator.send(AnalysisCompleted(fid, int(feats.valid.sum())))

        if not self._initialized:
            result = self._try_initialize(fid, ts, feats)
        else:
            result = self._track(fid, ts, feats)
        self._results[fid] = result
        self._drive_fuser(ts, result)
        return result

    def fossilize(self) -> FossilizedMap:
        """Stop, run global BA to its error floor, and return the immutable
        trajectory and map (MAGESlam::Fossilize, MAGESlam.cpp:322-383)."""
        s = self.settings
        chunk = max(int(s.graph_optimization.num_steps), 10)
        if self._initialized:
            self._map, _ = global_ba.global_ba_to_floor(
                self._map, s, self.fx, lam0=self._lam, chunk_steps=chunk)
        return FossilizedMap.from_engine(self)

    def get_tracking_results_for_frames(self, frame_ids):
        """Per-frame results with poses re-read from the pose history, so
        they reflect all later optimization
        (MAGESlam::GetTrackingResultsForFrames)."""
        return tracking_results_from_history(
            self._history, self._map.kf_pose, self._map.kf_valid,
            self._results, frame_ids)

    def process_stereo_frames(self, img1, img2, extrinsics,
                              timestamp: Optional[float] = None):
        """MAGESlam::ProcessStereoFrames (MageSlam.h:156): bootstrap the
        map metrically from one calibrated pair, then track on the primary
        camera.  ``extrinsics`` (7,) maps camera-1 coordinates to camera-2
        coordinates.  Returns the (primary, secondary) results."""
        fid = self._frame_id
        ts = timestamp if timestamp is not None else fid / 30.0
        extr = np.asarray(extrinsics, np.float32)
        if self._initialized:
            r1 = self.process_frame(img1, timestamp)
            r2 = TrackingResult(r1.frame_id, r1.timestamp, r1.state,
                                None if r1.pose is None else se3.pose_compose(
                                    torch.as_tensor(extr),
                                    torch.as_tensor(r1.pose)).numpy())
            return r1, r2
        self._frame_id += 1
        f1 = self._extract(img1)
        f2 = self._extract(img2)
        self._feed_bow_training(f1)
        res = stereo.stereo_initialize(
            f1, f2, torch.as_tensor(extr, device=self.device),
            self.settings.stereo.map_init, self.fx)
        if not bool(res.success):
            r = TrackingResult(fid, ts, TrackingState.INITIALIZING)
            self._results[fid] = r
            return r, r
        self._map, self._history, s0, _ = seed_map_from_stereo(
            self._map, self._history, f1, f2, res, extr, fid, ts)
        self._initialized = True
        self._pose_prev = se3.pose_identity(self.device)
        self._pose_prev2 = se3.pose_identity(self.device)
        self._last_kf = int(s0)
        self._frames_since_kf = 0
        self._kf_frame_ids = [fid]
        r1 = TrackingResult(fid, ts, TrackingState.TRACKING,
                            se3.pose_identity().numpy())
        r2 = TrackingResult(fid, ts, TrackingState.TRACKING, extr)
        self._results[fid] = r1
        return r1, r2

    def try_get_volume_of_interest(self):
        """MAGESlam::TryGetVolumeOfInterest (MageSlam.h:178)."""
        return volume_of_interest_from_map(self._map, self.cal,
                                           self.settings)

    @property
    def map_state(self) -> ms.MapState:
        return self._map

    @property
    def num_keyframes(self) -> int:
        return int(self._map.kf_valid.sum())

    @property
    def num_map_points(self) -> int:
        return int(self._map.mp_valid.sum())

    @property
    def loops_closed(self) -> int:
        return self._loops_closed

    # ------------------------------------------------------------------
    # initialization (InitializationWorker.cpp:40-95)
    # ------------------------------------------------------------------

    def _try_initialize(self, fid, ts, feats) -> TrackingResult:
        s = self.settings.mono.map_init
        self._init_buffer.append((fid, ts, feats))
        # drop buffered frames beyond the max interval
        self._init_buffer = [
            (f, t, ft) for (f, t, ft) in self._init_buffer
            if ts - t <= s.max_initialization_interval_ms / 1000.0]

        # the newest frame satisfying the min interval (smallest eligible
        # baseline: wide pairs lose matchability fastest)
        partner = None
        for (f, t, ft) in self._init_buffer:
            if ts - t >= s.min_initialization_interval_ms / 1000.0:
                partner = (f, t, ft)
        if partner is None:
            return TrackingResult(fid, ts, TrackingState.INITIALIZING)

        draws = initialization.draw_init(self.sampler_factory(), partner[2],
                                         feats, s)
        res = initialization.attempt_initialization(draws, partner[2], feats,
                                                    s, self.fx)
        if not bool(res.success):
            return TrackingResult(fid, ts, TrackingState.INITIALIZING)

        self._seed_map(partner, (fid, ts, feats), res)
        return TrackingResult(fid, ts, TrackingState.TRACKING,
                              _np(res.pose1))

    def _seed_map(self, frame0, frame1, res: initialization.InitResult):
        (fid0, ts0, f0), (fid1, ts1, f1) = frame0, frame1
        F = f0.valid.shape[0]
        dev = self.device
        # mean viewing direction = camera->point unit vector (camera 0 is
        # at the origin), matching the visibility gate of tracking
        d0 = torch.linalg.vector_norm(res.points, dim=-1)
        normal = res.points / torch.clamp(d0, min=1e-9)[:, None]
        sf = float(self.settings.mono.camera.features.scale_factor)
        self._map, mp_ids = ms.allocate_map_points(
            self._map, res.points, f0.desc, normal, 0, res.point_valid,
            octave=f0.octave, max_dist=d0 * sf ** f0.octave.to(torch.float32))
        created = mp_ids >= 0
        none = torch.full_like(mp_ids, -1)
        # keyframe 0 at identity (immortal: the gauge origin)
        assoc0 = torch.where(created, mp_ids, none)
        ident = se3.pose_identity(dev)
        self._map, s0 = ms.insert_keyframe(self._map, ident, f0, assoc0,
                                           fid0, immortal=True)
        # keyframe 1 associations through the match index
        feat1 = torch.clamp(res.match_idx, min=0)
        tgt = torch.where(created & (res.match_idx >= 0), feat1,
                          torch.full_like(feat1, F))
        assoc1 = util.scatter_set_last(
            torch.full((F + 1,), -1, dtype=torch.int32, device=dev), tgt,
            torch.where(created, mp_ids, none))[:F]
        self._map, s1 = ms.insert_keyframe(self._map, res.pose1, f1, assoc1,
                                           fid1, immortal=True)

        self._history = ph.add_pose(self._history, fid0, ts0, ident,
                                    torch.stack([s0, s1]).to(torch.int32),
                                    self._map.kf_pose)
        self._history = ph.add_pose(self._history, fid1, ts1, res.pose1,
                                    torch.stack([s1, s0]).to(torch.int32),
                                    self._map.kf_pose)
        self._initialized = True
        self._init_probation = True
        self._init_points = int(res.num_points)
        self._init_buffer.clear()
        self._pose_prev = res.pose1
        # zero-velocity prior: the init pair spans several frames, so
        # extrapolating its delta per frame would overshoot
        self._pose_prev2 = res.pose1
        self._last_kf = int(s1)
        self._frames_since_kf = 0
        self._kf_frame_ids = [fid0, fid1]
        if self._prior_provider is not None:
            self._prior_provider.on_tracking_pose(ts1, _np(res.pose1))
        self.mediator.send(InitCompleted(fid1, 2, self.num_map_points))

    # ------------------------------------------------------------------
    # steady-state tracking (Runtime.cpp:165-232 TrackFrame)
    # ------------------------------------------------------------------

    def _motion_prior(self) -> torch.Tensor:
        if self._pose_prev2 is None:
            return self._pose_prev
        return se3.constant_velocity_extrapolate(self._pose_prev2,
                                                 self._pose_prev)

    def _track(self, fid, ts, feats) -> TrackingResult:
        s = self.settings
        prior = None
        if self._prior_provider is not None:
            prior = self._prior_provider.get_pose_for_time(ts)
        if prior is None:
            prior = self._motion_prior()
            self._det("Tracking/prior", fid, _np(prior))
        else:
            self._det("Tracking/prior", fid, np.asarray(prior))
            prior = torch.as_tensor(np.asarray(prior, np.float32),
                                    device=self.device)
        tres = track.track_frame(self._map, feats, prior, self._last_kf,
                                 self.cal, s,
                                 max_local_kf=s.capacity.local_ba_keyframes)
        self._det("Tracking/assoc", fid, _np(tres.assoc),
                  int(tres.num_matched))
        # third-frame confirmation (MinThirdFrameMatchPercentage,
        # MageSettings.h:102): the first tracked frame after init must
        # re-find enough of the init map points, or the init was a bad
        # draw: wipe and re-bootstrap
        if self._init_probation:
            self._init_probation = False
            need = int(np.ceil(
                s.mono.map_init.min_third_frame_match_percentage
                * self._init_points))
            mse_ok = float(tres.mean_sq_error) \
                <= s.mono.map_init.third_frame_max_mse_px2 * self.px * self.px
            if not (bool(tres.success) and int(tres.num_inliers) >= need
                    and mse_ok):
                self._reset_map()
                return TrackingResult(fid, ts, TrackingState.INITIALIZING)
        if not bool(tres.success):
            self._lost_count += 1
            if self._lost_count >= s.track_local_map \
                    .tracking_lost_count_until_reloc:
                self.mediator.send(TrackingLost(fid, self._lost_count))
                return self._relocalize(fid, ts, feats)
            return TrackingResult(fid, ts, TrackingState.SKIPPED)

        self._lost_count = 0
        pose = tres.pose
        ref_kf = int(tres.ref_kf)
        self._det("TrackingThread", fid, _np(pose), int(tres.num_inliers))

        # N-anchor pose history: the nearest keyframe (last_kf) leads,
        # then the top covisible keyframes (PoseHistory.cpp:34-52)
        dev = self.device
        anchors = torch.cat([torch.full((1,), self._last_kf,
                                        dtype=torch.int32, device=dev),
                             tres.anchor_kf[:ph.N_ANCHORS - 1]
                             .to(torch.int32)])
        aok = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                         tres.anchor_ok[:ph.N_ANCHORS - 1]])
        self._history = ph.add_pose(self._history, fid, ts, pose, anchors,
                                    self._map.kf_pose, anchor_ok=aok)
        # recent-point stats
        self._map = culling.accumulate_tracking_stats(
            self._map, tres.local_mp_mask, tres.found_mp_mask)

        # idle-time polish: keep refining the last window between
        # keyframes until its error floor (the infant map right after
        # initialization depends on it)
        if not self._ba_converged:
            self._idle_polish()

        # keyframe decision, on host values
        self._frames_since_kf += 1
        self._frames_since_reloc += 1
        mem_ref = int(ms.member_matrix(self._map)[ref_kf].sum())
        cam_c = se3.camera_center(pose)
        ref_c = se3.camera_center(self._map.kf_pose[ref_kf])
        y = se3.pose_apply(pose[None], self._map.mp_pos)
        depths = torch.where(tres.found_mp_mask & (y[:, 2] > 0), y[:, 2],
                             torch.full_like(y[:, 2], float("inf")))
        min_depth = float(torch.amin(depths))
        pc = s.mono.camera
        dense = keyframe_decision.densely_connected(
            _np(feats.uv), _np(tres.assoc >= 0),
            self.cal.width, self.cal.height,
            pc.keyframe_decision_grid_width,
            pc.keyframe_decision_grid_height,
            pc.keyframe_decision_min_map_points_per_grid_cell,
            pc.keyframe_decision_allowed_empty_cell_percentage)
        decision = should_add_keyframe(s.keyframe, KeyframeDecisionInputs(
            frames_since_keyframe=self._frames_since_kf,
            frames_since_reloc=self._frames_since_reloc,
            num_tracked_points=int(tres.num_inliers),
            ref_kf_point_count=mem_ref,
            num_matches=int(tres.num_matched),
            mapping_idle=True,  # synchronous mapping: always idle
            motion_distance=float(torch.linalg.vector_norm(cam_c - ref_c)),
            min_scene_depth=min_depth if np.isfinite(min_depth) else 1.0,
            densely_connected=dense,
        ))
        prev_for_model = self._pose_prev
        if decision:
            slot = self._mapping_step(fid, feats, pose, tres.assoc)
            if slot is not None:
                # motion-prior re-basing (TrackLocalMapWorker.cpp:121-204):
                # local BA or loop closure may have moved the keyframe just
                # inserted; after = before o D, so apply D to both
                # motion-model poses to keep the velocity
                corrected = self._map.kf_pose[slot]
                D = se3.pose_compose(se3.pose_inverse(pose), corrected)
                pose = corrected
                if prev_for_model is not None:
                    prev_for_model = se3.pose_compose(prev_for_model, D)

        self._pose_prev2 = prev_for_model
        self._pose_prev = pose
        pose_np = _np(pose)
        if self._prior_provider is not None:
            self._prior_provider.on_tracking_pose(ts, pose_np)
        self.mediator.send(PoseRefined(fid, pose_np,
                                       is_keyframe=bool(decision),
                                       num_inliers=int(tres.num_inliers)))
        return TrackingResult(fid, ts, TrackingState.TRACKING, pose_np)

    def _ba_thresholds(self):
        ba = self.settings.bundle_adjust
        return (_f32(ba.huber_width * self.px),
                _f32(ba.max_outlier_error * self.px))

    def _build_window(self, center: int) -> local_ba.LocalBAWindow:
        cap = self.settings.capacity
        return local_ba.build_local_window(
            self._map, center, int(self._covis_threshold),
            window_size=cap.local_ba_keyframes, num_fixed=NUM_FIXED,
            max_points=cap.local_ba_points)

    def _mse_floor(self) -> float:
        return float(self.settings.bundle_adjust.min_mean_square_error) \
            * self.px * self.px

    def _chunk(self) -> int:
        return max(int(self.settings.bundle_adjust.num_steps_per_run), 1) * 8

    def _idle_polish(self):
        """One LM chunk on a rebuilt window around the last keyframe: the
        synchronous counterpart of the fused engine's idle-time BA."""
        s = self.settings
        win = self._build_window(self._last_kf)
        res = bundle_adjust(
            win.problem, *self._ba_thresholds(), num_steps=self._chunk(),
            lam0=self._lam if s.mapping.persist_lambda else 1e-4,
            pose_tethers=False)  # the window's one tether slot is unused
        win = win._replace(problem=win.problem._replace(
            kf_poses=res.kf_poses, points=res.points))
        if s.mapping.persist_lambda:
            self._lam = max(float(res.lam), s.mapping.min_lambda)
        self._map = local_ba.apply_window_result(self._map, win, res)
        self._ba_converged = (float(res.mean_sq_error) <= self._mse_floor()
                              or float(res.lam) >= 100.0)

    def _feed_bow_training(self, feats):
        """Accumulate descriptors and train the vocabulary once enough
        frames arrived (ImageAnalyzer.cpp:124 + OnlineBow training)."""
        s = self.settings.bag_of_words
        if self._bow_trained:
            return
        self._bow_training.append((feats.desc, feats.valid))
        if len(self._bow_training) >= s.training_frames:
            desc = torch.cat([d for d, _ in self._bow_training])
            valid = torch.cat([v for _, v in self._bow_training])
            if int(valid.sum()) >= min(s.min_training_size, 256):
                vocab = bv.train_vocabulary_sampled(
                    self.sampler_factory(), desc, valid,
                    iters=s.max_training_iteration)
                self._bow = self._bow._replace(vocab=vocab)
                self._bow_trained = True
                self._bow_training.clear()
                # signatures of the keyframes inserted before training
                for slot in np.nonzero(_np(self._map.kf_valid))[0]:
                    self._bow = bdb.add_keyframe(
                        self._bow, int(slot), self._map.kf_desc[slot],
                        self._map.kf_feat_valid[slot])
            else:
                self._bow_training.pop(0)

    def _relocalize(self, fid, ts, feats) -> TrackingResult:
        """Lost-mode recovery: BoW candidates, then PnP (reference
        PoseEstimationWorker.cpp:74-97 lost path).

        Infant-map reset: if tracking dies while the map is still tiny
        (<= 3 keyframes), the initialization was weak: wipe and
        re-bootstrap rather than stay lost."""
        if self.num_keyframes <= 3:
            self._reset_map()
            return TrackingResult(fid, ts, TrackingState.RELOCALIZING)
        if self._bow_trained:
            s = self.settings
            dev = self.device
            cand_idx, _, cand_ok = bdb.query(
                self._bow, feats.desc, feats.valid,
                torch.zeros_like(self._map.kf_valid),
                qualifying_score=s.bag_of_words.qualifying_candidate_score,
                max_results=s.mapping.max_reloc_query_results)
            # the most recent keyframe is always a candidate: the online
            # vocabulary's ranking is too noisy to guarantee that the
            # map-frontier keyframe surfaces
            cand_idx = torch.cat([torch.full((1,), self._last_kf,
                                             dtype=torch.int32, device=dev),
                                  cand_idx])
            cand_ok = torch.cat([self._map.kf_valid[self._last_kf][None],
                                 cand_ok])
            rres = relocalization.relocalize(
                self.sampler_factory(), self._map, feats, cand_idx, cand_ok,
                s.relocalization, self.fx)
            if bool(rres.success):
                # re-track from the recovered prior to refine and associate
                tres = track.track_frame(self._map, feats, rres.pose,
                                         int(rres.candidate_kf), self.cal, s)
                if bool(tres.success):
                    self._lost_count = 0
                    self._frames_since_reloc = 0
                    pose = tres.pose
                    self._history = ph.add_pose(
                        self._history, fid, ts, pose, tres.anchor_kf,
                        self._map.kf_pose, anchor_ok=tres.anchor_ok)
                    self._pose_prev = pose
                    self._pose_prev2 = pose  # zero-velocity restart
                    # the recovered frame becomes a keyframe at once, so
                    # new-point creation resumes from its viewpoint
                    self._mapping_step(fid, feats, pose, tres.assoc)
                    return TrackingResult(fid, ts, TrackingState.TRACKING,
                                          _np(pose))
        return TrackingResult(fid, ts, TrackingState.RELOCALIZING)

    def _reset_map(self):
        cap = self.settings.capacity
        self._map = self._empty_map()
        self._history = ph.empty_history(cap.pose_history_size, self.device)
        self._initialized = False
        self._init_buffer.clear()
        self._pose_prev = None
        self._pose_prev2 = None
        self._lost_count = 0
        self._kf_frame_ids = []

    # ------------------------------------------------------------------
    # mapping (MappingWorker.cpp:147-372)
    # ------------------------------------------------------------------

    def _cull_and_reanchor(self, cres):
        dead = cres.kf_culled_mask
        targets = ph.nearest_valid_kf(self._map.kf_valid, dead,
                                      self._map.kf_frame_id)
        self._history = ph.reanchor(self._history, self._map.kf_pose,
                                    self._map.kf_valid, dead, targets)
        self._bow = bdb.remove_keyframes(self._bow, dead)

    def _mapping_step(self, fid, feats, pose, assoc):
        s = self.settings

        # capacity guard: with every keyframe slot taken, force-cull the
        # most redundant mortal keyframe first (an insert would otherwise
        # take slot 0)
        if self.num_keyframes >= self._map.kf_valid.shape[0]:
            cres = culling.cull_keyframes(self._map, self._last_kf, 0.0, 1)
            if int(cres.num_keyframes_culled) == 0:
                return None  # nothing cullable: drop this keyframe
            self._cull_and_reanchor(cres)
            self._map = cres.map

        # 1. insert the keyframe with its tracked associations (+ BoW)
        self._map, slot = ms.insert_keyframe(self._map, pose, feats, assoc,
                                             fid)
        slot = int(slot)
        # the promoted frame's trajectory pose now lives on its own
        # keyframe, so later BA refinements reach it
        self._history = ph.anchor_frame_to_kf(self._history, fid, slot)
        self._ba_converged = False
        self._last_kf = slot
        self._frames_since_kf = 0
        self._kf_frame_ids.append(fid)
        if self._bow_trained:
            self._bow = bdb.add_keyframe(self._bow, slot, feats.desc,
                                         feats.valid)

        # 1.5 cheap loop closure: re-associate distant map points into the
        # new keyframe (MappingWorker.cpp:30-75,160-165)
        if s.mapping.use_cheap_loop_closure:
            self._map = cheap_loop_closure(self._map, slot, self.cal,
                                           s.loop_closure).map
            self._det("Mapping/cheap_lc", fid, _np(self._map.kf_assoc[slot]))

        # 2. recent-map-point culling
        self._map, _ = culling.cull_recent_map_points(
            self._map, _f32(s.track_local_map.recent_map_point_pct_success),
            int(s.mapping.min_num_keyframes_for_map_point_culling))
        self._det("Mapping/cull_recent", fid, self.num_map_points)

        # 3. new map points
        npres = new_points.create_new_map_points(
            self._map, slot, self.cal, s.mapping.new_map_points, self.fx,
            num_candidates=int(s.mapping.new_map_points
                               .max_frames_for_new_points_creation),
            scale_factor=float(s.mono.camera.features.scale_factor))
        self._map = npres.map
        self._det("Mapping/new_points", fid, int(npres.num_created),
                  _np(self._map.mp_pos))

        # 4. local BA with an adaptive covisibility threshold and a
        # persisted lambda
        win = self._build_window(slot)
        n_conn = int(win.problem.obs_valid.sum())
        cv = s.covisibility
        if n_conn > cv.upper_connections_for_ba:
            self._covis_threshold += cv.covis_ba_step_threshold
        elif n_conn < cv.lower_connections_for_ba:
            self._covis_threshold = max(
                cv.covis_min_threshold,
                self._covis_threshold - cv.covis_ba_step_threshold)

        # IterateBA (MappingWorker.cpp:330-372): LM in NumSteps-sized
        # chunks until the error floor; under-iterating lets unconverged
        # depths bias the next poses (a scale-collapse feedback loop)
        chunk = self._chunk()
        max_total = max(10 * chunk, 80)
        mse_floor = self._mse_floor()
        huber, max_outlier = self._ba_thresholds()

        def run_window(win):
            lam = self._lam if s.mapping.persist_lambda else 1e-4
            problem = win.problem
            res = None
            for _ in range(max_total // chunk):
                res = bundle_adjust(problem, huber, max_outlier,
                                    num_steps=chunk, lam0=lam,
                                    pose_tethers=False)
                problem = problem._replace(kf_poses=res.kf_poses,
                                           points=res.points)
                lam = res.lam
                if float(res.mean_sq_error) <= mse_floor:
                    break
            win = win._replace(problem=problem)
            if s.mapping.persist_lambda:
                self._lam = max(float(res.lam), s.mapping.min_lambda)
            self._map = local_ba.apply_window_result(self._map, win, res)
            return win, res

        win, res = run_window(win)
        # a second pass on a rebuilt window: outlier unassociation and the
        # first pass's moves change which observations belong in it
        if s.track_local_map.unassociate_outliers:
            self._map = local_ba.unassociate_outliers(self._map, win, res)
        win2, res2 = run_window(self._build_window(slot))
        if s.track_local_map.unassociate_outliers:
            self._map = local_ba.unassociate_outliers(self._map, win2, res2)
        self._det("Mapping/ba", fid, float(res2.mean_sq_error),
                  float(res2.lam), _np(self._map.kf_pose))
        self.mediator.send(HistoryUpdated("local_ba"))

        # 5. keyframe culling + history re-anchoring
        kf = s.keyframe
        cres = culling.cull_keyframes(
            self._map, slot, _f32(kf.mapping_max_tracking_point_overlap),
            int(kf.min_keyframe_covisibility_count))
        if int(cres.num_keyframes_culled) > 0:
            self._cull_and_reanchor(cres)
        # representative descriptor + viewing direction refresh
        # (MapPoint.cpp:80-131) once per mapping commit
        self._map = ms.refresh_point_representatives(cres.map)

        self._det("MappingThread", fid, _np(self._map.kf_pose[slot]),
                  self.num_keyframes, self.num_map_points)

        # 6. loop closure per keyframe (Runtime.cpp:527-529)
        if (s.loop_closure.enable_loop_closure and self._bow_trained
                and self.num_keyframes >= s.loop_closure.min_keyframe):
            self._attempt_loop_closure(slot)
            self._det("Mapping/loop", fid, self._loops_closed,
                      _np(self._map.kf_pose[slot]))
        return slot

    def _attempt_loop_closure(self, slot: int):
        s = self.settings
        sampler = self.sampler_factory()
        # the detection's own first stage: with no candidate past its
        # gates nothing is drawn and nothing found, so the rest is skipped
        cands = loop_closure.loop_candidates(self._map, self._bow, slot,
                                             s.loop_closure)
        if not bool(cands.cand_ok.any()):
            return
        det = loop_closure.detect_loop(
            sampler, self._map, self._bow, slot, s.loop_closure,
            s.relocalization, self.fx, candidates=cands)
        if not bool(det.found):
            return
        # CloseLoop: similarity correction (through the essential graph
        # with the pose graph) + merge + global polish
        if s.loop_closure.use_pose_graph:
            self._map = loop_closure.pose_graph_loop_correction(
                self._map, slot, det,
                num_steps=int(s.loop_closure.pose_graph_steps),
                min_covis=int(s.loop_closure.pose_graph_min_covis))
        else:
            self._map = loop_closure.apply_similarity_correction(
                self._map, slot, det)
        self._map = loop_closure.merge_loop_points(
            self._map, slot, det, self.cal, s.loop_closure)
        lc_ba = s.loop_closure.bundle_adjust
        # a fresh lambda for the repair BA: after a similarity correction
        # the problem changed entirely, and a large carried-over lambda
        # would make it a no-op
        self._map, _ = global_ba.engine_global_bundle_adjust(
            self._map, s, self.fx, num_steps=max(int(lc_ba.num_steps), 5),
            lam0=1e-4, huber_width_px=float(lc_ba.huber_width),
            max_outlier_px=float(lc_ba.max_outlier_error))
        self._loops_closed += 1
        self.mediator.send(HistoryUpdated("loop_closure"))
