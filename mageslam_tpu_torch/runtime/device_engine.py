"""The fused per-frame engine: frontend, mapping unit, init or tracking.

Port of ``mageslam_tpu/runtime/device_engine.py`` at its default
settings: relocalization, cheap loop closure and loop closure with the
Sim(3) pose graph included.  Engine state lives on the engine's device; each
``lax.cond`` of the JAX step becomes a Python ``if`` on values read back
from the device.  Those reads are the step's host synchronisations: they
are batched so that one read serves every decision it can, and counted in
``DeviceEngine.host_syncs``.  The ``lax.while_loop`` of ``drain_mapping``
is a Python loop.

Randomness: the JAX state carries a PRNG key; here the engine owns a
``torch.Generator`` (initialization RANSAC, BoW training and the PnP RANSAC
of relocalization and loop detection draw from it).  While tracking holds
and no loop candidate passes its gates the step draws nothing, so a state
carried over from the JAX engine steps identically (``convert.py``); the
parity tests hand the engine a ``sampler_factory`` that draws with
``jax.random`` on the JAX engine's key schedule.

Work the JAX step runs masked and discards is skipped here where the state
comes out the same: a loop detection whose candidates all fail their gates
costs one host read instead of eight relocalizations.

Every setting of the fused engine runs, the parallel layer's distributed
and trajectory-sharded global BA (fossilize) included.  Multi-level
pyramids run through the frontend and the tracking gates; stereo
bootstrap, the IMU fuser, pose-prior providers and drop-frame pacing live
in the facade (``runtime/fused.py``); an external
pose prior enters ``step`` as ``ext_prior``.  ``undistort_image_pixels``
is accepted and, as in the JAX engine's step, does not change the step:
it calls ``extract_features``, which undistorts keypoints; only
``extract_for_settings`` (stereo initialization) rectifies the image.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mageslam_tpu_torch.config import MageSlamSettings
from mageslam_tpu_torch.bow import database as bdb
from mageslam_tpu_torch.bow import vocab as bv
from mageslam_tpu_torch.geometry import se3
from mageslam_tpu_torch.geometry.camera import CameraCalibration
from mageslam_tpu_torch.loop import closure as lc
from mageslam_tpu_torch.mapping import (culling, global_ba, local_ba,
                                        new_points)
from mageslam_tpu_torch.mapping.cheap_loop_closure import cheap_loop_closure
from mageslam_tpu_torch.mapstore import map_state as ms
from mageslam_tpu_torch.mapstore import pose_history as ph
from mageslam_tpu_torch.ops import pyramid, util
from mageslam_tpu_torch.runtime.devices import resolve_device
from mageslam_tpu_torch.solvers import sampling
from mageslam_tpu_torch.solvers.bundle_adjust import (BAProblem, BAResult,
                                                      bundle_adjust_impl,
                                                      empty_tethers)
from mageslam_tpu_torch.tracking import initialization, relocalization, track
from mageslam_tpu_torch.tracking.frontend import (FrameFeatures,
                                                  empty_features,
                                                  extract_features)
from mageslam_tpu_torch.utils.tracing import PROFILER

CODE_SKIPPED = 0
CODE_INITIALIZING = 1
CODE_TRACKING = 2
CODE_RELOCALIZING = 3

INIT_RING = 8
OUT_WIDTH = 24
PENDING_RING = 4
NUM_FIXED = 8


class EngineState(NamedTuple):
    map: ms.MapState
    history: ph.PoseHistory
    vocab: bv.Vocabulary
    kf_sig: torch.Tensor
    kf_sig_valid: torch.Tensor
    train_desc: torch.Tensor
    train_valid: torch.Tensor
    train_frames: torch.Tensor
    bow_trained: torch.Tensor
    init_feats: FrameFeatures
    init_ts: torch.Tensor
    init_fid: torch.Tensor
    pend_feats: FrameFeatures
    pend_pose: torch.Tensor
    pend_assoc: torch.Tensor
    pend_fid: torch.Tensor
    pend_gen: torch.Tensor
    pend_count: torch.Tensor
    ba_window: local_ba.LocalBAWindow
    ba_active: torch.Tensor
    ba_steps_left: torch.Tensor
    ba_center: torch.Tensor
    ba_outliers: torch.Tensor
    ba_converged: torch.Tensor
    ba_reopened: torch.Tensor
    initialized: torch.Tensor
    init_probation: torch.Tensor
    init_points: torch.Tensor
    pose_prev: torch.Tensor
    pose_prev2: torch.Tensor
    last_kf: torch.Tensor
    frames_since_kf: torch.Tensor
    frames_since_reloc: torch.Tensor
    lost_count: torch.Tensor
    lam: torch.Tensor
    covis_threshold: torch.Tensor
    loops_closed: torch.Tensor


# scalar state values are built on the device by a fill, never copied from
# the host (a host-to-device copy would synchronise the stream)
def _i32(v, dev):
    return torch.full((), v, dtype=torch.int32, device=dev)


def _f32(v, dev):
    return torch.full((), v, dtype=torch.float32, device=dev)


def _b(v, dev):
    return torch.full((), bool(v), dtype=torch.bool, device=dev)


def _ring(f: FrameFeatures, n: int) -> FrameFeatures:
    return FrameFeatures(*[x[None].expand((n,) + x.shape).clone()
                           for x in f])


def _empty_window(window_size: int, num_fixed: int, max_points: int,
                  dev) -> local_ba.LocalBAWindow:
    M, LB = window_size + num_fixed, max_points
    problem = BAProblem(
        kf_poses=se3.pose_identity(dev).expand(M, 7).clone(),
        kf_fixed=torch.ones(M, dtype=torch.bool, device=dev),
        points=torch.zeros((LB, 3), dtype=torch.float32, device=dev),
        point_valid=torch.zeros(LB, dtype=torch.bool, device=dev),
        obs_kf=torch.arange(M, dtype=torch.int32, device=dev)
        .expand(LB, M).clone(),
        obs_xn=torch.zeros((LB, M, 2), dtype=torch.float32, device=dev),
        obs_valid=torch.zeros((LB, M), dtype=torch.bool, device=dev),
        **empty_tethers(1, dev))
    return local_ba.LocalBAWindow(
        problem, torch.zeros(M, dtype=torch.int32, device=dev),
        torch.zeros(M, dtype=torch.bool, device=dev),
        torch.zeros(M, dtype=torch.bool, device=dev),
        torch.zeros(LB, dtype=torch.int32, device=dev),
        torch.zeros(LB, dtype=torch.bool, device=dev))


def empty_state(settings: MageSlamSettings, device=None) -> EngineState:
    cap = settings.capacity
    dev = resolve_device(device)
    K, F, L = cap.max_keyframes, cap.max_features, cap.max_map_points
    train_cap = settings.bag_of_words.training_frames * F
    ident = se3.pose_identity(dev)
    return EngineState(
        map=ms.empty_map(K, F, L, dev),
        history=ph.empty_history(cap.pose_history_size, dev),
        vocab=bv.empty_vocabulary(dev),
        kf_sig=torch.zeros((K, bv.NUM_LEAVES), dtype=torch.float32,
                           device=dev),
        kf_sig_valid=torch.zeros(K, dtype=torch.bool, device=dev),
        train_desc=torch.zeros((train_cap, 8), dtype=torch.int32,
                               device=dev),
        train_valid=torch.zeros(train_cap, dtype=torch.bool, device=dev),
        train_frames=_i32(0, dev),
        bow_trained=_b(False, dev),
        init_feats=_ring(empty_features(F, dev), INIT_RING),
        init_ts=torch.zeros(INIT_RING, dtype=torch.float32, device=dev),
        init_fid=torch.full((INIT_RING,), -1, dtype=torch.int32, device=dev),
        pend_feats=_ring(empty_features(F, dev), PENDING_RING),
        pend_pose=ident.expand(PENDING_RING, 7).clone(),
        pend_assoc=torch.full((PENDING_RING, F), -1, dtype=torch.int32,
                              device=dev),
        pend_fid=torch.full((PENDING_RING,), -1, dtype=torch.int32,
                            device=dev),
        pend_gen=torch.zeros(PENDING_RING, dtype=torch.int32, device=dev),
        pend_count=_i32(0, dev),
        ba_window=_empty_window(cap.local_ba_keyframes, NUM_FIXED,
                                cap.local_ba_points, dev),
        ba_active=_b(False, dev),
        ba_steps_left=_i32(0, dev),
        ba_center=_i32(0, dev),
        ba_outliers=torch.zeros((cap.local_ba_points,
                                 cap.local_ba_keyframes + NUM_FIXED),
                                dtype=torch.bool, device=dev),
        ba_converged=_b(False, dev),
        ba_reopened=_b(False, dev),
        initialized=_b(False, dev),
        init_probation=_b(False, dev),
        init_points=_i32(0, dev),
        pose_prev=ident.clone(),
        pose_prev2=ident.clone(),
        last_kf=_i32(0, dev),
        frames_since_kf=_i32(0, dev),
        frames_since_reloc=_i32(10000, dev),
        lost_count=_i32(0, dev),
        lam=_f32(settings.mapping.min_lambda, dev),
        covis_threshold=_f32(settings.covisibility.covis_min_threshold, dev),
        loops_closed=_i32(0, dev),
    )


def _reset_slam_state(st: EngineState,
                      settings: MageSlamSettings) -> EngineState:
    """Infant-map reset (keeps BoW training + vocabulary)."""
    cap = settings.capacity
    dev = st.init_ts.device
    ident = se3.pose_identity(dev)
    return st._replace(
        map=ms.empty_map(cap.max_keyframes, cap.max_features,
                         cap.max_map_points, dev),
        history=ph.empty_history(cap.pose_history_size, dev),
        kf_sig_valid=torch.zeros_like(st.kf_sig_valid),
        init_fid=torch.full_like(st.init_fid, -1),
        pend_fid=torch.full_like(st.pend_fid, -1),
        pend_count=_i32(0, dev), ba_active=_b(False, dev),
        ba_steps_left=_i32(0, dev), ba_converged=_b(False, dev),
        ba_reopened=_b(False, dev), initialized=_b(False, dev),
        init_probation=_b(False, dev), init_points=_i32(0, dev),
        pose_prev=ident.clone(), pose_prev2=ident.clone(),
        last_kf=_i32(0, dev), frames_since_kf=_i32(0, dev),
        lost_count=_i32(0, dev))


def _pack_output(code, pose, n_inliers, n_kf, n_mp, loops, is_kf, n_feats,
                 stage_fp=None) -> torch.Tensor:
    head = torch.stack([
        code.to(torch.float32).reshape(()),
        *pose.unbind(-1),
        n_inliers.to(torch.float32).reshape(()),
        n_kf.to(torch.float32).reshape(()),
        n_mp.to(torch.float32).reshape(()),
        loops.to(torch.float32).reshape(()),
        is_kf.to(torch.float32).reshape(()),
        n_feats.to(torch.float32).reshape(())])
    parts = [head]
    if stage_fp is not None:
        parts.append(stage_fp)
    out = torch.cat(parts)
    return torch.cat([out, out.new_zeros(OUT_WIDTH - out.shape[0])])


_MASK32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 a in [0, 2^32) and a 32-bit constant,
    split in 16-bit halves so no product leaves int64."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


def _hash_fold(*arrays) -> torch.Tensor:
    """Position-sensitive 24-bit content hash as an exact float32: the
    JAX package's uint32 murmur-style fold, in int64 with & 0xFFFFFFFF."""
    h = torch.full((), 2166136261, dtype=torch.int64,
                   device=arrays[0].device)
    for a in arrays:
        if a.dtype == torch.bool:
            bits = a.to(torch.int64)
        elif a.dtype == torch.float32:
            bits = util.bitcast_u32(a)
        else:
            bits = util.bitcast_u32(a.to(torch.int32))
        bits = bits.reshape(-1)
        idx = torch.arange(bits.shape[0], dtype=torch.int64,
                           device=bits.device)
        x = _mul32(bits ^ _mul32(idx, 0x9E3779B9), 0x85EBCA6B)
        x = x ^ (x >> 13)
        x = _mul32(x, 0xC2B2AE35)
        x = x ^ (x >> 16)
        h = (h * 16777619 + x.sum()) & _MASK32
    return (h & 0xFFFFFF).to(torch.float32)


def _frontend_fingerprint(feats: FrameFeatures) -> torch.Tensor:
    v = feats.valid
    return _hash_fold(torch.where(v[:, None], feats.uv,
                                  torch.zeros_like(feats.uv)),
                      torch.where(v, feats.response,
                                  torch.zeros_like(feats.response)),
                      torch.where(v[:, None], feats.desc,
                                  torch.zeros_like(feats.desc)))


def _map_fingerprints(m: ms.MapState):
    poses_fp = _hash_fold(torch.where(m.kf_valid[:, None], m.kf_pose,
                                      torch.zeros_like(m.kf_pose)))
    points_fp = _hash_fold(torch.where(m.mp_valid[:, None], m.mp_pos,
                                       torch.zeros_like(m.mp_pos)))
    assoc_fp = _hash_fold(torch.where(m.kf_assoc >= 0, m.kf_assoc,
                                      torch.full_like(m.kf_assoc, -1)))
    return poses_fp, points_fp, assoc_fp


def check_supported(settings: MageSlamSettings) -> None:
    """Raise ``NotImplementedError`` for settings this port does not run.
    Every setting of the JAX package runs now, the parallel layer's
    included (``mapping/global_ba.engine_global_bundle_adjust``), so
    nothing raises; the fused engine and ``MageSlamTorch`` keep calling
    this as the one place where such a setting would."""


class DeviceEngine:
    """Owns settings, calibration, device, generator and the host-sync
    count; ``step`` advances an ``EngineState`` by one frame.

    ``sampler_factory()`` returns the ``sampler(p, num, k)`` of one
    relocalization or loop detection (``solvers/sampling.py``); it is
    called once per attempt, where the JAX engine splits its key.  The
    default draws from the engine's generator.

    ``counts`` is the engine's counter store, exact on the host and always
    on, like ``host_syncs`` (each ``_read``): relocalizations tried and
    accepted (``reloc_tried``, ``reloc_accepted``), loop attempts gated out
    for want of candidates and run (``loop_no_candidates``,
    ``loop_detections``), LM iterations of local BA (``lm_steps``,
    ``ba_per_run`` a call), keyframes inserted into the map, the initial
    ones included (``keyframes_inserted``), culls at keyframe capacity
    before an insertion (``force_culls``) and local-BA windows opened, by
    insertion or reopening (``ba_windows_opened``).  The stages' spans are
    ``utils/tracing.PROFILER``'s."""

    def __init__(self, settings: MageSlamSettings, cal: CameraCalibration,
                 device=None, seed: int = 0, sampler_factory=None):
        check_supported(settings)
        self.settings = settings
        self.device = resolve_device(device)
        self.cal = cal.to(self.device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.sampler_factory = sampler_factory or (
            lambda: sampling.generator_sampler(self.gen))
        self.host_syncs = 0
        self.counts = dict(reloc_tried=0, reloc_accepted=0,
                           loop_no_candidates=0, loop_detections=0,
                           lm_steps=0, keyframes_inserted=0, force_culls=0,
                           ba_windows_opened=0)
        # associations installed by cheap loop closure, summed on the device
        self.cheap_loop_associations = torch.zeros(
            (), dtype=torch.int64, device=self.device)
        s = settings
        cap = s.capacity
        self.fx = float(cal.fx)
        self.px = 1.0 / self.fx
        self.F = cap.max_features
        self.K_total = cap.max_keyframes
        self.ba_per_run = max(int(s.bundle_adjust.num_steps_per_run), 1) * 8
        self.ba_total = max(10 * self.ba_per_run, 80)
        self.mse_floor = float(s.bundle_adjust.min_mean_square_error) \
            * self.px * self.px

    # ------------------------------------------------------------------
    def _read(self, *xs):
        """One device->host read of several scalars (one sync)."""
        self.host_syncs += 1
        vals = torch.stack([x.reshape(()).to(torch.float64) for x in xs])
        with PROFILER.scope("sync"):
            return vals.tolist()

    def _f32c(self, v: float) -> float:
        return float(torch.tensor(v, dtype=torch.float32))

    def empty_state(self) -> EngineState:
        return empty_state(self.settings, self.device)

    # ------------------------------------------------------------------
    def feed_bow_training(self, st: EngineState, feats: FrameFeatures):
        T = self.settings.bag_of_words.training_frames
        trained, frames = self._read(st.bow_trained, st.train_frames)
        if not trained and frames < T:
            start = int(frames) * self.F
            # in place: the ring of training descriptors is engine-owned
            st.train_desc[start:start + self.F] = feats.desc
            st.train_valid[start:start + self.F] = feats.valid
            frames += 1
            st = st._replace(train_frames=st.train_frames + 1)
        if not trained and frames >= T:
            vocab = bv.train_vocabulary(
                self.gen, st.train_desc, st.train_valid,
                iters=self.settings.bag_of_words.max_training_iteration)
            sigs = bv.signatures(vocab, st.map.kf_desc, st.map.kf_feat_valid)
            st = st._replace(vocab=vocab, bow_trained=_b(True, self.device),
                             kf_sig=sigs, kf_sig_valid=st.map.kf_valid.clone())
        return st

    # ------------------------------------------------------------------
    def init_branch(self, st: EngineState, feats: FrameFeatures, ts, fid):
        s = self.settings
        si = s.mono.map_init
        dev = self.device
        F = self.F
        empty = st.init_fid < 0
        oldest = torch.argmin(torch.where(st.init_fid >= 0, st.init_ts,
                                          torch.full_like(st.init_ts,
                                                          float("inf"))))
        slot = torch.where(empty.any(), util.first_true(empty), oldest)
        # in place: the init ring is engine-owned (the JAX engine donated
        # its state buffers for the same reason)
        for r, f in zip(st.init_feats, feats):
            r[slot] = f
        ts32 = self._f32c(ts)
        st.init_ts[slot] = ts32
        st.init_fid[slot] = int(fid)
        age = ts32 - st.init_ts
        elig = (st.init_fid >= 0) & (st.init_fid != int(fid)) \
            & (age >= si.min_initialization_interval_ms / 1000.0) \
            & (age <= si.max_initialization_interval_ms / 1000.0)
        partner = torch.argmax(torch.where(
            elig, st.init_ts, torch.full_like(st.init_ts, float("-inf"))))
        (has_partner,) = self._read(elig.any())
        ident = se3.pose_identity(dev)
        if not has_partner:
            # no eligible pair: the attempt could not succeed, so it is not
            # run (the JAX step runs it and discards it; its pose lands in
            # the output row of this non-tracking frame)
            return st, CODE_INITIALIZING, ident, torch.zeros(
                (), dtype=torch.int64, device=dev)
        f0 = FrameFeatures(*[r[partner] for r in st.init_feats])
        draws = initialization.sample_init_draws(self.gen, f0, feats, si)
        ires = initialization.attempt_initialization(draws, f0, feats, si,
                                                     self.fx)
        (success,) = self._read(ires.success)
        if success:
            st = self._seed_map(st, f0, feats, ires, partner, ts, fid)
        code = CODE_TRACKING if success else CODE_INITIALIZING
        return st, code, ires.pose1, torch.zeros((), dtype=torch.int64,
                                                 device=dev)

    def _seed_map(self, st, f0, feats, ires, partner, ts, fid):
        s = self.settings
        fe = s.mono.camera.features
        dev = self.device
        F = self.F
        m = st.map
        d0 = torch.linalg.vector_norm(ires.points, dim=-1)
        normal = ires.points / torch.clamp(d0, min=1e-9)[:, None]
        m, mp_ids = ms.allocate_map_points(
            m, ires.points, f0.desc, normal, 0, ires.point_valid,
            octave=f0.octave,
            max_dist=d0 * float(fe.scale_factor)
            ** f0.octave.to(torch.float32))
        created = mp_ids >= 0
        assoc0 = torch.where(created, mp_ids, torch.full_like(mp_ids, -1))
        pfid = st.init_fid[partner]
        pts = st.init_ts[partner]
        ident = se3.pose_identity(dev)
        m, s0 = ms.insert_keyframe(m, ident, f0, assoc0, pfid,
                                   immortal=True)
        feat1 = torch.clamp(ires.match_idx, min=0)
        tgt = torch.where(created & (ires.match_idx >= 0), feat1,
                          torch.full_like(feat1, F))
        assoc1 = util.scatter_set_last(
            torch.full((F + 1,), -1, dtype=torch.int32, device=dev), tgt,
            torch.where(created, mp_ids, torch.full_like(mp_ids, -1)))[:F]
        m, s1 = ms.insert_keyframe(m, ires.pose1, feats, assoc1, int(fid),
                                   immortal=True)
        self.counts["keyframes_inserted"] += 2
        h = ph.add_pose(st.history, pfid, pts, ident,
                        torch.stack([s0, s1]).to(torch.int32), m.kf_pose)
        h = ph.add_pose(h, int(fid), self._f32c(ts), ires.pose1,
                        torch.stack([s1, s0]).to(torch.int32), m.kf_pose)
        sig0 = bv.signature(st.vocab, f0.desc, f0.valid)
        sig1 = bv.signature(st.vocab, feats.desc, feats.valid)
        kf_sig = st.kf_sig.clone()
        kf_sig[s0] = sig0
        kf_sig[s1] = sig1
        kf_sig_valid = st.kf_sig_valid.clone()
        kf_sig_valid[s0] = st.bow_trained
        kf_sig_valid[s1] = st.bow_trained
        return st._replace(
            map=m, history=h, kf_sig=kf_sig, kf_sig_valid=kf_sig_valid,
            initialized=_b(True, dev), init_probation=_b(True, dev),
            init_points=created.sum().to(torch.int32),
            pose_prev=ires.pose1, pose_prev2=ires.pose1,
            last_kf=s1.to(torch.int32), frames_since_kf=_i32(0, dev),
            init_fid=torch.full_like(st.init_fid, -1))

    # ------------------------------------------------------------------
    def _rebase_prior(self, st, before, after):
        D = se3.pose_compose(se3.pose_inverse(before), after)
        return st._replace(pose_prev=se3.pose_compose(st.pose_prev, D),
                           pose_prev2=se3.pose_compose(st.pose_prev2, D))

    def enqueue_keyframe(self, st, feats, pose, assoc, fid, pend_count):
        if pend_count >= PENDING_RING:
            st = self._roll_pending(st, clear_fid=False)
            pend_count -= 1
        slot = pend_count
        # in place: the pending FIFO is engine-owned
        for r, f in zip(st.pend_feats, feats):
            r[slot] = f
        st.pend_pose[slot] = pose
        st.pend_assoc[slot] = assoc
        st.pend_fid[slot] = int(fid)
        st.pend_gen[slot] = st.map.num_kf_ever
        return st._replace(pend_count=_i32(pend_count + 1, self.device),
                           frames_since_kf=_i32(0, self.device))

    def _roll_pending(self, st, clear_fid: bool):
        fid = torch.roll(st.pend_fid, -1, 0)
        if clear_fid:
            fid[-1] = -1
        return st._replace(
            pend_feats=FrameFeatures(*[torch.roll(r, -1, 0)
                                       for r in st.pend_feats]),
            pend_pose=torch.roll(st.pend_pose, -1, 0),
            pend_assoc=torch.roll(st.pend_assoc, -1, 0),
            pend_fid=fid,
            pend_gen=torch.roll(st.pend_gen, -1, 0),
            pend_count=st.pend_count - 1)

    def drain_pending(self, st: EngineState) -> EngineState:
        s = self.settings
        cap = s.capacity
        fe = s.mono.camera.features
        feats = FrameFeatures(*[r[0].clone() for r in st.pend_feats])
        pose = st.pend_pose[0].clone()
        assoc = st.pend_assoc[0].clone()
        fid = st.pend_fid[0].clone()
        gen = st.pend_gen[0].clone()
        st = self._roll_pending(st, clear_fid=True)
        L = st.map.mp_valid.shape[0]
        a_safe = torch.clamp(assoc, 0, L - 1).long()
        stale = (assoc >= 0) & (~st.map.mp_valid[a_safe]
                                | (st.map.mp_created_kf_gen[a_safe] > gen))
        assoc = torch.where(stale, torch.full_like(assoc, -1), assoc)

        (n_kf,) = self._read(st.map.kf_valid.sum())
        if n_kf >= self.K_total:
            self.counts["force_culls"] += 1
            cres = culling.cull_keyframes(st.map, st.last_kf, 0.0, 1,
                                          window=self.K_total)
            dead = cres.kf_culled_mask
            targets = ph.nearest_valid_kf(st.map.kf_valid, dead,
                                          st.map.kf_frame_id)
            h = ph.reanchor(st.history, st.map.kf_pose, st.map.kf_valid,
                            dead, targets)
            st = st._replace(map=cres.map, history=h,
                             kf_sig_valid=st.kf_sig_valid & ~dead)
            (n_kf,) = self._read(st.map.kf_valid.sum())
        if n_kf >= self.K_total:
            return st

        m, slot = ms.insert_keyframe(st.map, pose, feats, assoc, fid)
        self.counts["keyframes_inserted"] += 1
        st = st._replace(history=ph.anchor_frame_to_kf(st.history, fid,
                                                       slot))
        sig = bv.signature(st.vocab, feats.desc, feats.valid)
        kf_sig = st.kf_sig.clone()
        kf_sig[slot] = sig
        kf_sig_valid = st.kf_sig_valid.clone()
        kf_sig_valid[slot] = st.bow_trained
        if s.mapping.use_cheap_loop_closure:
            cheap = cheap_loop_closure(m, slot, self.cal, s.loop_closure)
            m = cheap.map
            self.cheap_loop_associations += cheap.num_connected
        m, _ = culling.cull_recent_map_points(
            m, self._f32c(s.track_local_map.recent_map_point_pct_success),
            int(s.mapping.min_num_keyframes_for_map_point_culling))
        npres = new_points.create_new_map_points(
            m, slot, self.cal, s.mapping.new_map_points, self.fx,
            num_candidates=int(s.mapping.new_map_points
                               .max_frames_for_new_points_creation),
            scale_factor=float(fe.scale_factor))
        m = npres.map
        win = local_ba.build_local_window(
            m, slot, st.covis_threshold.to(torch.int32),
            window_size=cap.local_ba_keyframes, num_fixed=NUM_FIXED,
            max_points=cap.local_ba_points)
        n_conn = win.problem.obs_valid.sum()
        cv = s.covisibility
        thr = st.covis_threshold
        thr = torch.where(n_conn > cv.upper_connections_for_ba,
                          thr + cv.covis_ba_step_threshold, thr)
        thr = torch.where(n_conn < cv.lower_connections_for_ba,
                          torch.clamp(thr - cv.covis_ba_step_threshold,
                                      min=float(cv.covis_min_threshold)),
                          thr)
        dev = self.device
        self.counts["ba_windows_opened"] += 1
        return st._replace(
            map=m, kf_sig=kf_sig, kf_sig_valid=kf_sig_valid,
            covis_threshold=thr, last_kf=slot.to(torch.int32),
            ba_window=win, ba_active=_b(True, dev),
            ba_steps_left=_i32(self.ba_total, dev),
            ba_center=slot.to(torch.int32),
            ba_outliers=torch.zeros_like(st.ba_outliers),
            ba_converged=_b(False, dev), ba_reopened=_b(False, dev))

    def finish_mapping(self, st: EngineState, try_loop: bool) -> EngineState:
        """Close out the window: outlier unassociation, keyframe culling +
        history reanchor, then a loop-closure attempt on the mapped
        keyframe when ``try_loop`` (the caller's read of ``_loop_gate``: the
        gate's inputs do not change in between)."""
        s = self.settings
        slot = st.ba_center
        with PROFILER.scope("mapping.finish"):
            m = st.map
            if s.track_local_map.unassociate_outliers:
                fake = BAResult(st.ba_window.problem.kf_poses,
                                st.ba_window.problem.points, None, st.lam,
                                st.ba_outliers, None)
                m = local_ba.unassociate_outliers(m, st.ba_window, fake)
            cres = culling.cull_keyframes(
                m, slot,
                self._f32c(s.keyframe.mapping_max_tracking_point_overlap),
                int(s.keyframe.min_keyframe_covisibility_count))
            dead = cres.kf_culled_mask
            targets = ph.nearest_valid_kf(m.kf_valid, dead, m.kf_frame_id)
            h = ph.reanchor(st.history, m.kf_pose, m.kf_valid, dead, targets)
            m_fresh = ms.refresh_point_representatives(cres.map)
            dev = self.device
            st = st._replace(map=m_fresh, history=h,
                             kf_sig_valid=st.kf_sig_valid & ~dead,
                             ba_active=_b(False, dev),
                             ba_steps_left=_i32(0, dev))
        if s.loop_closure.enable_loop_closure and try_loop:
            with PROFILER.scope("mapping.loop"):
                st = self.try_loop(st, slot.long())
        return st

    def _loop_gate(self, st: EngineState) -> torch.Tensor:
        return st.bow_trained & (st.map.num_kf_ever
                                 >= self.settings.loop_closure.min_keyframe)

    def try_loop(self, st: EngineState, slot) -> EngineState:
        """Loop detection on the mapped keyframe and, when a loop is found,
        its correction, point merge and repair BA."""
        s = self.settings
        db = bdb.BowDatabase(st.vocab, st.kf_sig, st.kf_sig_valid)
        # one sampler per attempt, drawn on or not: the JAX engine splits
        # its key here whatever the candidates are
        sampler = self.sampler_factory()
        cands = lc.loop_candidates(st.map, db, slot, s.loop_closure)
        (any_ok,) = self._read(cands.cand_ok.any())
        if not any_ok:
            self.counts["loop_no_candidates"] += 1
            return st
        self.counts["loop_detections"] += 1
        det = lc.detect_loop(sampler, st.map, db, slot, s.loop_closure,
                             s.relocalization, self.fx, candidates=cands)
        (found,) = self._read(det.found)
        if not found:
            return st
        before = st.map.kf_pose[slot]
        if s.loop_closure.use_pose_graph:
            m = lc.pose_graph_loop_correction(
                st.map, slot, det,
                num_steps=int(s.loop_closure.pose_graph_steps),
                min_covis=int(s.loop_closure.pose_graph_min_covis))
        else:
            m = lc.apply_similarity_correction(st.map, slot, det)
        m = lc.merge_loop_points(m, slot, det, self.cal, s.loop_closure)
        ba = s.loop_closure.bundle_adjust
        # a fresh lambda: after a similarity correction a large carried one
        # would make the repair BA a no-op
        m, _ = global_ba.global_bundle_adjust(
            m, self._f32c(ba.huber_width * self.px),
            self._f32c(ba.max_outlier_error * self.px),
            num_steps=max(int(ba.num_steps), 5), lam0=1e-4)
        st = st._replace(map=m, loops_closed=st.loops_closed + 1)
        return self._rebase_prior(st, before, m.kf_pose[slot])

    def ba_iterate(self, st: EngineState) -> EngineState:
        s = self.settings
        win = st.ba_window
        with PROFILER.scope("mapping.local_ba"):
            res = bundle_adjust_impl(
                win.problem,
                self._f32c(s.bundle_adjust.huber_width * self.px),
                self._f32c(s.bundle_adjust.max_outlier_error * self.px),
                num_steps=self.ba_per_run, lam0=st.lam,
                pose_tethers=False)  # the window's one tether slot is unused
            self.counts["lm_steps"] += self.ba_per_run
            lam = torch.clamp(res.lam, min=s.mapping.min_lambda) \
                if s.mapping.persist_lambda else st.lam
            win = win._replace(problem=win.problem._replace(
                kf_poses=res.kf_poses, points=res.points))
            center = st.ba_center.long()
            before = st.map.kf_pose[center]
            m = local_ba.apply_window_result(st.map, win, res)
            steps_left = st.ba_steps_left - self.ba_per_run
            converged = (res.mean_sq_error <= self.mse_floor) \
                | (res.lam >= 100.0) | (st.ba_reopened & (steps_left <= 0))
            st = st._replace(map=m, ba_window=win, lam=lam,
                             ba_steps_left=steps_left,
                             ba_outliers=res.outliers, ba_converged=converged)
            st = self._rebase_prior(st, before, m.kf_pose[center])
        done = (steps_left <= 0) | (st.pend_count > 0) \
            | (res.mean_sq_error <= self.mse_floor)
        done, try_loop = self._read(done, self._loop_gate(st))
        return self.finish_mapping(st, bool(try_loop)) if done else st

    def reopen_window(self, st: EngineState) -> EngineState:
        cap = self.settings.capacity
        win = local_ba.build_local_window(
            st.map, st.last_kf, st.covis_threshold.to(torch.int32),
            window_size=cap.local_ba_keyframes, num_fixed=NUM_FIXED,
            max_points=cap.local_ba_points)
        dev = self.device
        self.counts["ba_windows_opened"] += 1
        return st._replace(
            ba_window=win, ba_active=_b(True, dev),
            ba_steps_left=_i32(self.ba_total, dev), ba_center=st.last_kf,
            ba_outliers=torch.zeros_like(st.ba_outliers),
            ba_reopened=_b(True, dev))

    def advance_mapping(self, st: EngineState) -> EngineState:
        """One unit of mapping work per engine step."""
        can_reopen = st.map.kf_valid[st.last_kf.long()] \
            & (st.map.num_kf_ever > 2) & ~st.ba_converged
        active, pend, reopen = self._read(st.ba_active, st.pend_count,
                                          can_reopen)
        if active:
            return self.ba_iterate(st)
        if pend > 0:
            with PROFILER.scope("mapping.insert_keyframe"):
                st = self.drain_pending(st)
            (active,) = self._read(st.ba_active)
            return self.ba_iterate(st) if active else st
        if reopen:
            with PROFILER.scope("mapping.reopen_window"):
                st = self.reopen_window(st)
            return self.ba_iterate(st)
        return st

    # ------------------------------------------------------------------
    def track_branch(self, st: EngineState, feats: FrameFeatures, ts, fid,
                     ext_prior=None):
        s = self.settings
        cap = s.capacity
        cal = self.cal
        dev = self.device
        px = self.px
        # an external provider's prior (IMU, host strategy) when given,
        # else the built-in constant-velocity model
        prior = ext_prior if ext_prior is not None else \
            se3.constant_velocity_extrapolate(st.pose_prev2, st.pose_prev)
        tres = track.track_frame(st.map, feats, prior, st.last_kf, cal, s,
                                 max_local_kf=cap.local_ba_keyframes)
        with PROFILER.scope("tracking.keyframe_decision"):
            mi = s.mono.map_init
            need = torch.ceil(
                mi.min_third_frame_match_percentage
                * st.init_points.to(torch.float32)).to(torch.int64)
            mse_ok = tres.mean_sq_error \
                <= mi.third_frame_max_mse_px2 * px * px
            confirm_fail = st.init_probation \
                & ~(tres.success & (tres.num_inliers >= need) & mse_ok)
            st = st._replace(init_probation=_b(False, dev))

            # keyframe decision (computed for every frame; used on success)
            m = culling.accumulate_tracking_stats(
                st.map, tres.local_mp_mask, tres.found_mp_mask)
            ref_kf = tres.ref_kf.long()
            mapping_idle = (st.pend_count == 0) & (~st.ba_active
                                                   | st.ba_reopened)
            mem_ref = ms.member_matrix(m)[ref_kf].sum()
            pose = tres.pose
            cam_c = se3.camera_center(pose)
            ref_c = se3.camera_center(m.kf_pose[ref_kf])
            ydep = se3.pose_apply(pose[None], m.mp_pos)[:, 2]
            dmask = tres.found_mp_mask & (ydep > 0)
            min_depth = torch.amin(torch.where(
                dmask, ydep, torch.full_like(ydep, float("inf"))))
            min_depth = torch.where(torch.isfinite(min_depth), min_depth,
                                    torch.ones_like(min_depth))
            moved = torch.linalg.vector_norm(cam_c - ref_c) \
                >= s.keyframe.min_frame_move_to_min_depth_ratio * min_depth
            pc = s.mono.camera
            gw, gh = (pc.keyframe_decision_grid_width,
                      pc.keyframe_decision_grid_height)
            tracked = tres.assoc >= 0
            gx = torch.clamp(
                (feats.uv[:, 0] * gw / cal.width).to(torch.int32), 0, gw - 1)
            gy = torch.clamp(
                (feats.uv[:, 1] * gh / cal.height).to(torch.int32), 0, gh - 1)
            counts = torch.zeros(gw * gh, dtype=torch.int32, device=dev)
            counts = counts.index_add(0, (gx * gh + gy).long(),
                                      tracked.to(torch.int32))
            empty_pct = torch.mean(
                (counts < pc.keyframe_decision_min_map_points_per_grid_cell)
                .to(torch.float32))
            dense = empty_pct \
                <= pc.keyframe_decision_allowed_empty_cell_percentage
            kf = s.keyframe
            fsk = st.frames_since_kf + 1
            fsr = st.frames_since_reloc + 1
            cadence = (fsr > kf.min_frame_count_reloc) \
                & (mapping_idle | (fsk > kf.min_frame_count))
            n_inl = tres.num_inliers
            count_ok = (n_inl > kf.min_tracking_point_count) \
                & (n_inl < kf.max_tracking_point_matches)
            overlap_ok = n_inl < (mem_ref * kf.max_tracking_point_overlap
                                  + kf.min_tracking_point_count)
            sprint = (fsr <= kf.min_frame_count_reloc) & (fsk >= 1)
            want_kf = count_ok & ((cadence & (moved | ~dense) & overlap_ok)
                                  | sprint)
            lost_count = torch.where(tres.success, torch.zeros_like(
                st.lost_count), st.lost_count + 1)
            lost = ~tres.success & (lost_count >= s.track_local_map
                                    .tracking_lost_count_until_reloc)
            tiny = st.map.kf_valid.sum() <= 3
            success, want, is_lost, bow, cfail, is_tiny, pend = self._read(
                tres.success, want_kf, lost, st.bow_trained, confirm_fail,
                tiny, st.pend_count)

            if success:
                anchors = torch.cat([st.last_kf[None],
                                     tres.anchor_kf[:ph.N_ANCHORS - 1]])
                aok = torch.cat([torch.ones(1, dtype=torch.bool,
                                            device=dev),
                                 tres.anchor_ok[:ph.N_ANCHORS - 1]])
                h = ph.add_pose(st.history, int(fid), self._f32c(ts), pose,
                                anchors, st.map.kf_pose, anchor_ok=aok)
                st = st._replace(map=m, history=h, lost_count=lost_count,
                                 frames_since_kf=fsk.to(torch.int32),
                                 frames_since_reloc=fsr.to(torch.int32))
                if want:
                    st = self.enqueue_keyframe(st, feats, pose, tres.assoc,
                                               fid, int(pend))
                st = st._replace(pose_prev2=st.pose_prev, pose_prev=pose)
            else:
                st = st._replace(lost_count=lost_count.to(torch.int32))

        recovered, pose_out = False, tres.pose
        if is_lost and bow:
            with PROFILER.scope("tracking.relocalize"):
                st, recovered, rpose = self.relocalize_frame(
                    st, feats, ts, fid, int(pend))
            if recovered:
                pose_out = rpose
        code = CODE_TRACKING if success or recovered else (
            CODE_RELOCALIZING if is_lost else CODE_SKIPPED)
        if (is_lost and not recovered and is_tiny) or cfail:
            st = _reset_slam_state(st, s)
        if cfail:
            code = CODE_INITIALIZING
        return st, code, pose_out, tres.num_inliers

    def relocalize_frame(self, st: EngineState, feats: FrameFeatures, ts,
                         fid, pend_count: int):
        """The lost branch: BoW candidates (the last keyframe always among
        them), PnP RANSAC, then a re-track of the frame from the recovered
        pose.  Returns (state, recovered, pose)."""
        s = self.settings
        self.counts["reloc_tried"] += 1
        db = bdb.BowDatabase(st.vocab, st.kf_sig, st.kf_sig_valid)
        cand_idx, _, cand_ok = bdb.query(
            db, feats.desc, feats.valid, torch.zeros_like(st.map.kf_valid),
            qualifying_score=s.bag_of_words.qualifying_candidate_score,
            max_results=s.mapping.max_reloc_query_results)
        last = st.last_kf.long()
        cand_idx = torch.cat([st.last_kf[None].to(torch.int32), cand_idx])
        cand_ok = torch.cat([st.map.kf_valid[last][None], cand_ok])
        rres = relocalization.relocalize(
            self.sampler_factory(), st.map, feats, cand_idx,
            cand_ok & st.bow_trained, s.relocalization, self.fx)
        (ok,) = self._read(rres.success)
        if not ok:
            return st, False, rres.pose
        t2 = track.track_frame(st.map, feats, rres.pose,
                               torch.clamp(rres.candidate_kf, min=0),
                               self.cal, s,
                               max_local_kf=s.capacity.local_ba_keyframes)
        (ok,) = self._read(t2.success)
        if not ok:
            return st, False, rres.pose
        self.counts["reloc_accepted"] += 1
        h = ph.add_pose(st.history, int(fid), self._f32c(ts), t2.pose,
                        t2.anchor_kf, st.map.kf_pose, anchor_ok=t2.anchor_ok)
        dev = self.device
        st = st._replace(history=h, lost_count=_i32(0, dev),
                         frames_since_reloc=_i32(0, dev),
                         pose_prev=t2.pose, pose_prev2=t2.pose)
        # the recovered frame becomes a keyframe at once, so new-point
        # creation resumes from the recovery viewpoint
        st = self.enqueue_keyframe(st, feats, t2.pose, t2.assoc, fid,
                                   pend_count)
        return st, True, t2.pose

    # ------------------------------------------------------------------
    def _upload_prior(self, ext_prior) -> torch.Tensor:
        """The (7,) prior on the device: one copy, from pinned memory on a
        card, queued on the stream (no host wait)."""
        if torch.is_tensor(ext_prior):
            return ext_prior.to(self.device, torch.float32)
        host = torch.as_tensor(np.asarray(ext_prior, np.float32))
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host

    def step(self, st: EngineState, img, ts, fid, ext_prior=None):
        """One frame: returns (state, (OUT_WIDTH,) float32 output row).
        ``ext_prior`` (7,) replaces the constant-velocity pose prior of this
        frame's tracking."""
        s = self.settings
        fe = s.mono.camera.features
        img = torch.as_tensor(img)
        if img.device != self.device:
            img = img.to(self.device)
        if ext_prior is not None:
            ext_prior = self._upload_prior(ext_prior)
        with PROFILER.scope("frontend"):
            gray = pyramid.to_gray_f32(img)
            # undistort_image_pixels is not read here, as in the JAX step
            feats = extract_features(
                gray, self.cal, float(fe.fast_threshold),
                max_features=self.F, num_levels=int(fe.num_levels),
                scale_factor=float(fe.scale_factor),
                gaussian_ksize=int(fe.gaussian_kernel_size),
                use_orientation=bool(fe.use_orientation),
                cells_x=int(fe.num_cells_x), cells_y=int(fe.num_cells_y),
                use_subpixel=bool(getattr(fe, "use_subpixel", True)))
            st = self.feed_bow_training(st, feats)
        with PROFILER.scope("fingerprints"):
            fp_frontend = _frontend_fingerprint(feats)
        (initialized,) = self._read(st.initialized)
        if initialized:
            with PROFILER.scope("mapping"):
                st = self.advance_mapping(st)
        with PROFILER.scope("fingerprints"):
            fp_poses, fp_points, fp_assoc = _map_fingerprints(st.map)
            fp_ba = _hash_fold(st.lam, st.ba_steps_left,
                               st.ba_active.to(torch.int32))
        if initialized:
            with PROFILER.scope("tracking"):
                st, code, pose, n_inl = self.track_branch(st, feats, ts, fid,
                                                          ext_prior)
        else:
            with PROFILER.scope("init"):
                st, code, pose, n_inl = self.init_branch(st, feats, ts, fid)
        with PROFILER.scope("fingerprints"):
            _, _, fp_assoc_post = _map_fingerprints(st.map)
            fp_sched = _hash_fold(st.pend_count, st.frames_since_kf,
                                  st.lost_count, st.covis_threshold)
            stage_fp = torch.stack([fp_frontend, fp_poses, fp_points,
                                    fp_assoc, fp_ba, fp_assoc_post, fp_sched])
            code_t = _f32(float(code), self.device)
            is_kf = (st.frames_since_kf == 0) & (code == CODE_TRACKING)
            out = _pack_output(code_t, pose, n_inl,
                               st.map.kf_valid.sum(), st.map.mp_valid.sum(),
                               st.loops_closed, is_kf, feats.valid.sum(),
                               stage_fp)
        return st, out

    def drain_mapping(self, st: EngineState) -> EngineState:
        """Run the mapping pipeline to completion (flush / fossilize)."""
        while True:
            init, active, pend = self._read(st.initialized, st.ba_active,
                                            st.pend_count)
            if not (init and (active or pend > 0)):
                return st
            st = self.advance_mapping(st)
