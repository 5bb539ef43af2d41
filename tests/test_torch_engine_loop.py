"""The engine with relocalization, cheap loop closure and loop closure on.

Goldens come from ``tests/data/torch_ring150.npz``
(``tools/make_torch_ring_fixture.py``): the 150-frame ring with frames
130-137 blacked out, driven by the JAX engine on the CPU.

(i)   Carried-state window: the JAX engine's state after the last blackout
      frame is carried over, and the port steps the frames through the
      recovery to the end of the drive with ``jax.random`` draws on the JAX
      engine's key schedule (``JaxKeyFactory``).  Per-frame code, keyframe
      flag, keyframe and map-point counts and the association fingerprints
      must match exactly, poses within 1e-3, over the first ``EXACT`` = 5
      frames: the relocalization, the re-track and the keyframes made right
      after it.  At the sixth frame one map point of 1230 falls on the
      other side of a threshold (float32 sums in another order); from there
      on codes, keyframe flags and keyframe counts stay exact, the
      map-point count within 2 and the poses within 5e-3.
(ii)  One whole drive of the port with its own generator, compared by
      outcome: ``CODE_RELOCALIZING`` inside frames 130-139, no tracked frame
      in 131-137, tracked again within 6 frames of the JAX engine's
      recovery, tracked count >= JAX's - 5, finite fossil, ATE under the
      stored bound.  That bound is 1.5x the largest ATE of the JAX engine
      over three seeds of its own RNG (0.12, 0.38, 0.22 on this ring, whose
      extent is 8.5): one seed's ATE is a matter of luck.  The drive takes
      over 90 s on the CPU, so it is marked ``slow``.
(iii) The formal closure through the engine: the injected-drift state,
      ``try_loop`` with JAX's draws, then the pose history and the fossil.
(iv)  ``check_supported`` accepts the default settings and still names each
      unported one; the facade's ``reset``, ``process_sequence``,
      ``get_tracking_results_for_frames`` and loop counters.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mageslam_tpu_torch import MageSlamSettings, convert
from mageslam_tpu_torch.io.evaluation import ate_rmse
from mageslam_tpu_torch.mapstore import pose_history as ph
from mageslam_tpu_torch.runtime import device_engine as de
from mageslam_tpu_torch.runtime.fused import MageSlamTorchFused
from mageslam_tpu_torch.runtime.results import TrackingState

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_torch_ring_fixture import (DRIFT_SEED, OUT,  # noqa: E402
                                     decode_frames, fixture_settings)
from test_torch_engine import jax_state_namespace  # noqa: E402
from test_torch_loop import Drift  # noqa: E402
from test_torch_reloc import JaxKeySampler, ring_calibration  # noqa: E402

torch.set_num_threads(2)
EXACT = 5


class JaxKeyFactory:
    """``sampler_factory`` on the JAX engine's key schedule: the engine
    splits its key once per relocalization and once per loop-detection
    attempt, keeps one half and draws from the other."""

    def __init__(self, key):
        self.key = key

    def __call__(self):
        self.key, sub = jax.random.split(self.key)
        return JaxKeySampler(sub)


@pytest.fixture(scope="module")
def ring():
    return np.load(OUT)


def port_settings(name: str):
    return convert.settings_from_jax(fixture_settings(name))


def test_carried_state_recovery_window(ring):
    z = ring
    imgs = decode_frames(z)
    start = int(z["ring_state_pre_frame"])
    ns = jax_state_namespace(z, "ring_state_pre/")
    st = convert.engine_state_from_jax(ns)
    key = jax.random.wrap_key_data(jnp.asarray(ns.key_data))
    eng = de.DeviceEngine(port_settings("ring_fast"), ring_calibration(z),
                          device="cpu", seed=0,
                          sampler_factory=JaxKeyFactory(key))
    rows_t = []
    for i in range(start + 1, len(imgs)):
        st, out = eng.step(st, torch.as_tensor(imgs[i]),
                           float(z["timestamps"][i]), i)
        rows_t.append(out.numpy())
    rows_t = np.stack(rows_t)
    rj = z["ring_fast_rows"][start + 1:]
    # code, keyframe flag, keyframe / map-point counts, assoc fingerprints
    for col in (0, 12, 9, 10, 17, 19):
        np.testing.assert_array_equal(rows_t[:EXACT, col], rj[:EXACT, col],
                                      err_msg=f"output slot {col}")
    np.testing.assert_allclose(rows_t[:EXACT, 1:8], rj[:EXACT, 1:8],
                               atol=1e-3)
    for col in (0, 12, 9):
        np.testing.assert_array_equal(rows_t[:, col], rj[:, col],
                                      err_msg=f"output slot {col}")
    assert np.abs(rows_t[:, 10] - rj[:, 10]).max() <= 2
    np.testing.assert_allclose(rows_t[:, 1:8], rj[:, 1:8], atol=5e-3)
    # the window is the recovery: lost before it, tracking from its first
    # frame on, through one accepted relocalization
    assert int(ns.lost_count) > 0
    assert (rj[:, 0] == de.CODE_TRACKING).all()
    assert eng.counts["reloc_tried"] == eng.counts["reloc_accepted"] == 1
    assert int(st.frames_since_reloc) == len(rows_t) - 1


@pytest.mark.slow
def test_whole_ring_drive(ring):
    z = ring
    name = "ring_fast"
    imgs = decode_frames(z)
    gt = z["gt_poses"]
    eng = MageSlamTorchFused(port_settings(name), ring_calibration(z),
                             seed=1, device="cpu")
    eng.process_sequence(list(imgs), timestamps=z["timestamps"].tolist())
    results = eng.flush()
    fossil = eng.fossilize()
    codes = np.array([int(eng.output_row(i)[0]) for i in range(len(imgs))])
    reloc = np.nonzero(codes == de.CODE_RELOCALIZING)[0]
    assert len(reloc) and 130 <= reloc[0] <= 139
    assert not (codes[131:138] == de.CODE_TRACKING).any()
    back = np.nonzero(codes[138:] == de.CODE_TRACKING)[0]
    assert len(back) and 138 + back[0] <= int(z[f"{name}_recovery"]) + 6
    tracked = int((codes == de.CODE_TRACKING).sum())
    assert tracked >= int(z[f"{name}_tracked"]) - 5
    assert eng.engine.counts["reloc_accepted"] >= 1
    est, ref = [], []
    for i in range(len(imgs)):
        p = fossil.pose_for_frame(i)
        if results[i].state == TrackingState.TRACKING and p is not None:
            est.append(p)
            ref.append(gt[i])
    assert np.isfinite(fossil.poses).all()
    ate = ate_rmse(np.asarray(est), np.asarray(ref))[0]
    assert ate < float(z[f"{name}_ate_bound"]), (ate, z[f"{name}_ate_seeds"])


def test_try_loop_closes_the_injected_drift(ring):
    """The loop block of ``finish_mapping`` on the drifted map: detection,
    pose-graph correction, merge, repair BA, ``loops_closed + 1``, the
    motion prior re-based; afterwards every tracked frame of the pose
    history still resolves to a finite pose and the drain has nothing
    left to do."""
    d = Drift(ring)
    s = d.settings
    s = s.replace(loop_closure=dataclasses.replace(s.loop_closure,
                                                   use_pose_graph=True))
    eng = de.DeviceEngine(
        s, d.cal, device="cpu",
        sampler_factory=lambda: JaxKeySampler(jax.random.key(DRIFT_SEED)))
    st = d.state
    assert bool(eng._loop_gate(st))
    before = d.kf_ate(st.map)
    st2 = eng.try_loop(st, torch.tensor(d.slot))
    assert int(st2.loops_closed) == int(st.loops_closed) + 1
    assert eng.counts["loop_detections"] == 1
    after = d.kf_ate(st2.map)
    # the engine's repair BA takes max(num_steps, 5) steps, not the 25 of
    # the stored stages: most, not all, of the stored cut
    cut = before - float(ring["drift_pg_ate_ba"])
    assert before - after > 0.8 * cut, (before, after)
    assert int(st2.map.mp_valid.sum()) < int(st.map.mp_valid.sum())
    assert not torch.equal(st2.pose_prev, st.pose_prev)      # re-based
    poses, ok = ph.world_poses(st2.history, st2.map.kf_pose,
                               st2.map.kf_valid)
    assert int(ok.sum()) == int(ph.world_poses(
        st.history, st.map.kf_pose, st.map.kf_valid)[1].sum()) > 0
    assert torch.isfinite(poses[ok]).all()
    st3 = eng.drain_mapping(st2)
    assert int(st3.loops_closed) == int(st2.loops_closed)
    assert torch.isfinite(st3.map.kf_pose).all()


def test_loop_gate_and_candidate_skip(ring):
    """Before ``min_keyframe`` keyframes the loop block is not entered;
    past it, with every keyframe recent, the attempt costs one host read
    and leaves the state as it was."""
    z = ring
    ns = jax_state_namespace(z, "ring_state_pre/")
    st = convert.engine_state_from_jax(ns)
    s = port_settings("ring_fast")
    eng = de.DeviceEngine(s, ring_calibration(z), device="cpu")
    assert bool(eng._loop_gate(st))
    young = st._replace(map=st.map._replace(num_kf_ever=torch.tensor(
        s.loop_closure.min_keyframe - 1, dtype=st.map.num_kf_ever.dtype)))
    assert not bool(eng._loop_gate(young))
    recent = st._replace(map=st.map._replace(kf_frame_id=torch.clamp(
        st.map.kf_frame_id, min=int(st.map.kf_frame_id.max()) - 5)))
    syncs = eng.host_syncs
    out = eng.try_loop(recent, st.last_kf.long())
    assert eng.host_syncs == syncs + 1
    assert eng.counts["loop_no_candidates"] == 1
    assert eng.counts["loop_detections"] == 0
    assert out is recent


def test_check_supported_accepts_the_defaults(ring):
    s = MageSlamSettings()
    assert s.loop_closure.enable_loop_closure
    assert s.mapping.use_cheap_loop_closure
    de.check_supported(s)
    eng = MageSlamTorchFused(s, ring_calibration(ring), device="cpu")
    assert eng.loops_closed == 0 and eng.cheap_loop_associations == 0


def _with_levels(s):
    cam = s.mono.camera
    cam = dataclasses.replace(cam, features=dataclasses.replace(
        cam.features, num_levels=2))
    return s.replace(mono=dataclasses.replace(s.mono, camera=cam))


def _with_pixel_undistortion(s):
    cam = dataclasses.replace(s.mono.camera, undistort_image_pixels=True)
    return s.replace(mono=dataclasses.replace(s.mono, camera=cam))


def _bag(bag, field):
    return lambda s: s.replace(**{bag: dataclasses.replace(
        getattr(s, bag), **{field: True})})


@pytest.mark.parametrize("change,named", [
    (_with_levels, "num_levels"),
    (_with_pixel_undistortion, "undistort_image_pixels"),
    (_bag("stereo", "use_stereo_init"), "stereo"),
    (_bag("fuser", "use_fuser"), "IMU"),
    (_bag("parallel", "use_distributed_global_ba"), "parallel"),
    (_bag("parallel", "use_trajectory_sharding"), "parallel"),
    (_bag("runtime", "drop_frames_when_busy"), "drop-frame"),
], ids=["num_levels", "undistort_image_pixels", "stereo", "imu",
        "distributed_ba", "trajectory_sharding", "drop_frames"])
def test_unported_settings_still_raise(ring, change, named):
    """Every one of these settings is ported, the parallel layer's two
    included: the facade builds with each and runs a frame (name and ids
    kept so that the history stays in one place)."""
    s = change(MageSlamSettings())
    eng = MageSlamTorchFused(s, ring_calibration(ring), device="cpu")
    eng.process_frame(decode_frames(ring)[0], timestamp=0.0)
    assert eng.result_for(0).state == TrackingState.INITIALIZING
    assert eng.output_row(0)[13] > 100
    assert eng.frames_dropped == 0


def test_facade_reset_sequence_and_history(ring):
    """``process_sequence`` equals ``process_frame`` frame by frame;
    ``reset`` starts the same session again; poses re-read from the pose
    history are finite for every tracked frame."""
    z = ring
    imgs = list(decode_frames(z)[:24])
    ts = z["timestamps"][:24].tolist()
    eng = MageSlamTorchFused(port_settings("ring_fast"), ring_calibration(z),
                             seed=1, device="cpu")
    for img, t in zip(imgs, ts):
        eng.process_frame(img, timestamp=t)
    rows_a = np.stack([eng.output_row(i) for i in range(24)])
    eng.reset(seed=1)
    assert eng.result_for(0) is None and eng.num_keyframes == 0
    eng.process_sequence(imgs, timestamps=ts, chunk=5)
    rows_b = np.stack([eng.output_row(i) for i in range(24)])
    np.testing.assert_array_equal(rows_a, rows_b)
    assert (rows_b[:, 0] == de.CODE_TRACKING).sum() >= 15
    eng.flush()
    res = eng.get_tracking_results_for_frames(range(24))
    assert [r.frame_id for r in res] == list(range(24))
    for r in res:
        live = eng.result_for(r.frame_id)
        if live.state == TrackingState.TRACKING:
            assert r.state == TrackingState.TRACKING
            assert np.isfinite(r.pose).all()
            assert np.abs(r.pose[4:] - live.pose[4:]).max() < 0.5
    assert eng.loops_closed == 0
