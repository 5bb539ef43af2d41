"""Stereo bootstrap, pixel undistortion, tethers, volume of interest and the
facade's surface: the port against the JAX package.

Goldens come from ``tests/data/torch_facade.npz``
(``tools/make_torch_facade_fixture.py``: a stereo rig and 30 mono frames
driven through the JAX facade with an IMU prior provider and the fuser);
no JAX engine is compiled here.  Small JAX functions (remap, tethers,
bounding planes, voxel scoring) run live.  Tolerances:

- remap grid within 1e-4 px, rectified image within 1e-3 grey levels;
  the rectified frontend keeps at least 99% of JAX's keypoints;
- SIX_DOF / EXTRINSIC / DISTANCE tether residuals and normal-equation
  blocks within 1e-5 (relative to the block's scale);
- ``stereo_initialize`` on JAX's features: matches, validity and success
  exact, points within 1e-4 of the scene's depth;
- bounding planes and volume-of-interest corners within 1e-4;
- mediator events, determinism streams and the fuser's modes exact on the
  JAX drive's output rows, gravity and scale within 1e-5;
- pacing as ``tests/test_pacing.py`` with an injected ``busy_fn``;
- a carried-state window with the stored external priors: codes, keyframe
  flags and counts exact, poses within 1e-3.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mageslam_tpu.geometry.camera import CameraCalibration as JaxCal
from mageslam_tpu.mapstore import depths as jdepths
from mageslam_tpu.mapstore import map_state as jms
from mageslam_tpu.mapstore import volume_of_interest as jvoi
from mageslam_tpu.ops import undistort as jundistort
from mageslam_tpu.runtime import facade_common as jfc
from mageslam_tpu.solvers import bundle_adjust as jba
from mageslam_tpu.utils.determinism import Determinator as JaxDeterminator
from mageslam_tpu_torch import MageSlamSettings, convert
from mageslam_tpu_torch.config import BoundingDepthSettings, \
    VolumeOfInterestSettings
from mageslam_tpu_torch.fuser.samples import SensorSample
from mageslam_tpu_torch.geometry.camera import CameraCalibration
from mageslam_tpu_torch.mapstore import depths, volume_of_interest
from mageslam_tpu_torch.ops import undistort
from mageslam_tpu_torch.runtime import device_engine as de
from mageslam_tpu_torch.runtime import facade_common
from mageslam_tpu_torch.runtime.fused import MageSlamTorchFused
from mageslam_tpu_torch.runtime.results import TrackingState
from mageslam_tpu_torch.solvers import bundle_adjust as ba
from mageslam_tpu_torch.tracking import frontend, stereo
from mageslam_tpu_torch.utils.determinism import Determinator
from mageslam_tpu_torch.utils.mediator import (AnalysisCompleted,
                                               PoseRefined, TrackingLost)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_torch_facade_fixture import decode_frames  # noqa: E402
from test_torch_engine import (fixture_calibration, load_fixture,  # noqa
                               port_settings)

torch.set_num_threads(2)
FACADE = os.path.join(os.path.dirname(__file__), "data", "torch_facade.npz")


@pytest.fixture(scope="module")
def z():
    return np.load(FACADE)


def facade_settings(z) -> MageSlamSettings:
    return MageSlamSettings.from_json(str(z["st_settings_json"]))


def stereo_calibration(z) -> CameraCalibration:
    fx, fy, cx, cy, w, h = z["st_cal"].tolist()
    return CameraCalibration.pinhole(fx, fy, cx, cy, int(w), int(h))


def distorted(z):
    fx, fy, cx, cy, w, h = z["ud_cal"].tolist()
    k1, k2, _, _, k3 = z["ud_cal_dist"][:5].tolist()
    return (JaxCal.poly3k(fx, fy, cx, cy, k1, k2, k3, int(w), int(h)),
            CameraCalibration.poly3k(fx, fy, cx, cy, k1, k2, k3, int(w),
                                     int(h)))


def stored_features(z, prefix):
    return convert.features_from_jax(type("F", (), {
        k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}))


# ---------------------------------------------------------------------------
# pixel undistortion

def test_remap_grid_and_rectified_image_match_jax(z):
    jcal, cal = distorted(z)
    img = z["ud_img"].astype(np.float32)
    rect = undistort.ImageRectifier(cal)
    np.testing.assert_allclose(rect.grid("cpu").numpy(),
                               np.asarray(jundistort.remap_grid(jcal)),
                               rtol=0, atol=1e-4)
    got = rect(torch.as_tensor(img)).numpy()
    np.testing.assert_allclose(got, z["ud_rectified"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(
        got, np.asarray(jundistort.undistort_image(jnp.asarray(img), jcal)),
        rtol=0, atol=1e-3)
    assert rect.pinhole.model == 0 and rect.pinhole.fx == cal.fx


def test_rectified_frontend_matches_jax(z):
    _, cal = distorted(z)
    s = facade_settings(z)
    cam = s.mono.camera.__class__(**{**s.mono.camera.__dict__,
                                     "undistort_image_pixels": True})
    ft = convert.to_numpy(frontend.extract_for_settings(
        torch.as_tensor(z["ud_img"]).to(torch.float32), cal, cam,
        s.capacity.max_features))
    fj = {k[len("ud_feat/"):]: z[k] for k in z.files
          if k.startswith("ud_feat/")}
    kj = {(round(float(u), 2), round(float(v), 2))
          for (u, v), ok in zip(fj["uv"], fj["valid"]) if ok}
    kt = {(round(float(u), 2), round(float(v), 2))
          for (u, v), ok in zip(ft["uv"], ft["valid"]) if ok}
    assert len(kj) > 100
    assert len(kj & kt) >= 0.99 * len(kj), (len(kj & kt), len(kj))
    # detection ran against the pinhole calibration of the rectified image
    sel = ft["valid"]
    np.testing.assert_allclose(
        ft["xn_undist"][sel],
        np.stack([(ft["uv"][sel, 0] - cal.cx) / cal.fx,
                  (ft["uv"][sel, 1] - cal.cy) / cal.fy], -1), atol=1e-6)


# ---------------------------------------------------------------------------
# tethers and stereo initialization

# one compile for every case (the eager vmap of jacfwd takes seconds each)
_jax_tether_blocks = jax.jit(jba.tether_normal_contrib)
_jax_tether_error = jax.jit(jba.tether_error)


@pytest.mark.parametrize("ttype", [jba.TETHER_SIX_DOF, jba.TETHER_EXTRINSIC,
                                   jba.TETHER_DISTANCE, jba.TETHER_NONE])
def test_tether_blocks_match_jax(ttype):
    rng = np.random.default_rng(ttype)
    K, T = 5, 4
    xi = rng.normal(0, 0.3, (K, 6)).astype(np.float32)
    poses = np.asarray(jba.se3.pose_retract(
        jnp.tile(jba.se3.pose_identity()[None], (K, 1)), jnp.asarray(xi)))
    target = np.asarray(jba.se3.pose_retract(
        jnp.tile(jba.se3.pose_identity()[None], (T, 1)),
        jnp.asarray(rng.normal(0, 0.2, (T, 6)).astype(np.float32))))
    ti = np.array([1, 2, 3, 4], np.int32)
    tj = np.array([0, 1, 0, 2], np.int32)
    tt = np.full(T, ttype, np.int32)
    td = rng.uniform(0.1, 1.0, T).astype(np.float32)
    tw = np.array([50.0, 1.0, 3.0, 10.0], np.float32)
    args = (poses, ti, tj, tt, target, td, tw)
    Sj, bj = _jax_tether_blocks(*[jnp.asarray(a) for a in args])
    St, bt = ba.tether_normal_contrib(*[torch.as_tensor(a) for a in args])
    for got, want in ((St, Sj), (bt, bj)):
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * scale)
    rj = _jax_tether_error(*[jnp.asarray(a) for a in args])
    rt = ba.tether_error(*[torch.as_tensor(a) for a in args])
    assert float(rt) == pytest.approx(float(rj), rel=1e-5, abs=1e-6)
    if ttype == jba.TETHER_SIX_DOF:
        # a caller that declares no pose tether gets none
        S0, _ = ba.tether_normal_contrib(*[torch.as_tensor(a) for a in args],
                                         pose_tethers=False)
        assert float(S0.abs().max()) == 0.0


def test_stereo_initialize_on_jax_features(z):
    s = facade_settings(z)
    f1 = stored_features(z, "st_f1/")
    f2 = stored_features(z, "st_f2/")
    res = stereo.stereo_initialize(f1, f2, torch.as_tensor(z["st_extrinsics"]),
                                   s.stereo.map_init,
                                   float(stereo_calibration(z).fx))
    want = convert.to_numpy(convert.stereo_result_from_jax(type("R", (), {
        k[len("st_res/"):]: z[k] for k in z.files
        if k.startswith("st_res/")})))
    assert bool(res.success) == bool(want["success"]) is True
    np.testing.assert_array_equal(res.match_idx.numpy(), want["match_idx"])
    np.testing.assert_array_equal(res.point_valid.numpy(),
                                  want["point_valid"])
    assert int(res.num_points) == int(want["num_points"])
    ok = want["point_valid"]
    depth = float(np.median(want["points"][ok, 2]))
    np.testing.assert_allclose(res.points.numpy()[ok], want["points"][ok],
                               rtol=0, atol=1e-4 * depth)


def test_stereo_bootstrap_through_the_facade(z):
    """``process_stereo_frames`` on the stored pair: both results
    TRACKING, the secondary at the extrinsics, the seeded map as JAX's."""
    pair = decode_frames(z["st_pair_dy"])
    extr = z["st_extrinsics"]
    eng = MageSlamTorchFused(facade_settings(z), stereo_calibration(z),
                             seed=1, device="cpu")
    r1, r2 = eng.process_stereo_frames(pair[0], pair[1], extr, timestamp=0.0)
    assert [r1.state.value, r2.state.value] == z["st_pair_states"].tolist()
    np.testing.assert_allclose(np.stack([r1.pose, r2.pose]),
                               z["st_pair_poses"], atol=1e-6)
    assert eng.num_keyframes == int(z["st_keyframes"]) == 2
    m = eng.map_state
    pts = m.mp_pos[m.mp_valid].numpy()
    assert abs(len(pts) - int(z["st_map_points"])) <= 2
    assert np.median(pts[:, 2]) == pytest.approx(float(z["st_median_depth"]),
                                                 rel=1e-3)
    # once initialized, a pair is tracked on the primary camera
    mono = decode_frames(z["st_mono_dy"])
    r1, r2 = eng.process_stereo_frames(mono[0], mono[0], extr,
                                       timestamp=float(z["st_ts"][0]))
    # the pair's results resolve through the fetch ring, after the call
    assert r1.frame_id == r2.frame_id == 1
    assert r1.state == r2.state == TrackingState.SKIPPED and r2.pose is None
    r1 = eng.result_for(1)
    assert r1.state == TrackingState.TRACKING
    # the secondary pose is the rig extrinsics after a resolved primary
    want = np.asarray(jfc.se3.pose_compose(jnp.asarray(extr),
                                           jnp.asarray(r1.pose)))
    eng.process_frame = lambda img, timestamp=None: r1
    _, r2 = eng.process_stereo_frames(mono[1], mono[1], extr)
    np.testing.assert_allclose(r2.pose, want, atol=1e-6)


# ---------------------------------------------------------------------------
# bounding planes and volume of interest

def test_bounding_plane_depths_match_jax():
    rng = np.random.default_rng(3)
    jcal = JaxCal.pinhole(272.0, 272.0, 160.0, 90.0, 320, 180)
    cal = CameraCalibration.pinhole(272.0, 272.0, 160.0, 90.0, 320, 180)
    pts = (rng.normal(0, 1, (600, 3)) + [0, 0, 4]).astype(np.float32)
    poses = np.asarray(jba.se3.pose_retract(
        jnp.tile(jba.se3.pose_identity()[None], (5, 1)),
        jnp.asarray(rng.normal(0, 0.1, (5, 6)).astype(np.float32))))
    masks = rng.uniform(size=(5, 600)) > 0.3
    masks[4] = False
    for soft in (0.0, 0.4):
        s = BoundingDepthSettings(near_depth_softness=soft,
                                  far_depth_softness=soft)
        near, far, ok = depths.bounding_plane_depths(
            torch.as_tensor(poses), torch.as_tensor(pts),
            torch.as_tensor(masks), cal, s)
        for k in range(5):
            nj, fj, okj = jdepths.bounding_plane_depths(
                jnp.asarray(poses[k]), jnp.asarray(pts),
                jnp.asarray(masks[k]), jcal,
                jdepths.BoundingDepthSettings(near_depth_softness=soft,
                                              far_depth_softness=soft))
            assert bool(ok[k]) == bool(okj)
            assert float(near[k]) == pytest.approx(float(nj), abs=1e-4)
            assert float(far[k]) == pytest.approx(float(fj), abs=1e-4)


def test_volume_of_interest_matches_jax():
    rng = np.random.default_rng(5)
    poses = np.asarray(jba.se3.pose_retract(
        jnp.tile(jba.se3.pose_identity()[None], (6, 1)),
        jnp.asarray(rng.normal(0, 0.2, (6, 6)).astype(np.float32))))
    nears = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    fars = (nears + rng.uniform(1, 3, 6)).astype(np.float32)
    valid = np.array([1, 1, 1, 0, 1, 1], bool)
    vj = convert.volume_of_interest_from_jax(
        jvoi.compute_volume_of_interest(poses, nears, fars, valid))
    vt = volume_of_interest.compute_volume_of_interest(
        poses, nears, fars, valid, VolumeOfInterestSettings(), device="cpu")
    assert vt.valid == vj.valid is True
    np.testing.assert_allclose(vt.min_corner, vj.min_corner, atol=1e-4)
    np.testing.assert_allclose(vt.max_corner, vj.max_corner, atol=1e-4)
    assert not volume_of_interest.compute_volume_of_interest(
        poses, nears, fars, np.zeros(6, bool), device="cpu").valid


def test_volume_of_interest_from_map_matches_jax(z):
    """On the JAX drive's map after the carried-state frame."""
    prefix = "cs_state/map/"
    leaves = {k[len(prefix):]: z[k] for k in z.files
              if k.startswith(prefix)}
    mj = jms.MapState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    mt = convert.map_from_jax(type("M", (), leaves))
    s = facade_settings(z)
    jcal = JaxCal.pinhole(*z["st_cal"][:4].tolist(), 320, 180)
    from mageslam_tpu.config import MageSlamSettings as JaxSettings
    vj = jfc.volume_of_interest_from_map(
        mj, jcal, JaxSettings.from_json(str(z["st_settings_json"])))
    vt = facade_common.volume_of_interest_from_map(
        mt, stereo_calibration(z), s)
    assert vt is not None and vj is not None
    np.testing.assert_allclose(vt.min_corner, vj.min_corner, atol=1e-4)
    np.testing.assert_allclose(vt.max_corner, vj.max_corner, atol=1e-4)


# ---------------------------------------------------------------------------
# events, determinism streams, the fuser on the facade

def test_events_streams_and_fuser_on_jax_rows(z):
    """The JAX drive's output rows through the port facade's
    materialization, with the drive's IMU stream: the same events, the same
    checkpoint hashes, the same fuser modes, gravity and scale."""
    eng = MageSlamTorchFused(facade_settings(z), stereo_calibration(z),
                             device="cpu", determinator=Determinator())
    events = []
    eng.mediator.subscribe(AnalysisCompleted, lambda e: events.append(
        (0, e.frame_id, e.num_features, 0, 0)))
    eng.mediator.subscribe(PoseRefined, lambda e: events.append(
        (1, e.frame_id, int(e.is_keyframe), e.num_inliers, 0)))
    eng.mediator.subscribe(TrackingLost, lambda e: events.append(
        (2, e.frame_id, e.consecutive_failures, 0, 0)))
    stream = z["st_imu"]
    fed, modes = 0, []
    for i, t in enumerate(z["st_ts"]):
        while fed < len(stream) and stream[fed, 0] <= t + 1e-9:
            ts, ax, ay, az, wx, wy, wz = stream[fed]
            eng.add_sensor_sample(SensorSample.accel(ts, (ax, ay, az)))
            eng.add_sensor_sample(SensorSample.gyro(ts, (wx, wy, wz)))
            fed += 1
        eng._materialize(i + 1, float(t), z["st_rows"][i])
        modes.append(int(eng._fuser.mode))
    assert events == [tuple(e) for e in z["st_events"].tolist()]
    streams = eng.determinator.streams
    assert sorted(streams) == z["st_det_names"].tolist()
    for name, want in zip(z["st_det_names"], z["st_det"]):
        assert streams[str(name)] == want.tolist(), name
    # the stored streams are the JAX package's own hashes of these rows
    jdet = JaxDeterminator()
    jdet.check("FusedEngine", 1, z["st_rows"][0])
    assert jdet.streams["FusedEngine"][0] == streams["FusedEngine"][0]
    assert modes == z["st_modes"].tolist()
    np.testing.assert_allclose(eng.get_gravity_direction(), z["st_gravity"],
                               rtol=0, atol=1e-5)
    assert eng.get_scale() == pytest.approx(float(z["st_scale"]), abs=1e-5)


def test_carried_state_window_with_ext_prior(z):
    """From the JAX drive's state after frame ``cs_frame``, the next frames
    with the priors its IMU provider handed the engine."""
    start, n = int(z["cs_frame"]), int(z["cs_window"])
    st = convert.engine_state_from_npz(z, "cs_state/")
    eng = de.DeviceEngine(facade_settings(z), stereo_calibration(z),
                          device="cpu")
    mono = decode_frames(z["st_mono_dy"])
    rows = []
    for i in range(start, start + n):
        prior = z["st_priors"][i]
        assert np.isfinite(prior).all()
        st, out = eng.step(st, torch.as_tensor(mono[i]),
                           float(z["st_ts"][i]), i + 1, ext_prior=prior)
        rows.append(out.numpy())
    rows = np.stack(rows)
    want = z["st_rows"][start:start + n]
    for col in (0, 12, 9, 10):
        np.testing.assert_array_equal(rows[:, col], want[:, col],
                                      err_msg=f"output slot {col}")
    np.testing.assert_allclose(rows[:, 1:8], want[:, 1:8], atol=1e-3)
    assert (want[:, 0] == de.CODE_TRACKING).all()


# ---------------------------------------------------------------------------
# drop-frame pacing (tests/test_pacing.py)

def _paced(pacing: bool):
    s = port_settings("fast")
    return s.replace(runtime=s.runtime.__class__(
        **{**s.runtime.__dict__, "drop_frames_when_busy": pacing,
           "max_pipeline_depth": 3}))


def test_pacing_drops_stale_processes_latest():
    o = load_fixture()
    busy_frames = {6, 7, 8, 10, 11}
    state = {"i": -1}
    eng = MageSlamTorchFused(
        _paced(True), fixture_calibration(o), seed=1, device="cpu",
        busy_fn=lambda: 99 if state["i"] in busy_frames else 0)
    for i in range(14):
        state["i"] = i
        eng.process_frame(o["imgs"][i], timestamp=i / 30.0)
    results = eng.flush()
    assert all(i in results for i in range(14))
    # 6 and 7 are dropped as newer busy frames arrive, 8 goes at 9's
    # catch-up; then 10 is dropped and 11 goes at 12's
    assert eng.frames_dropped == 3
    for i in (6, 7, 10):
        assert results[i].state == TrackingState.SKIPPED
        assert eng.output_row(i) is None          # never reached the engine
    for i in (8, 11, 12, 13):
        assert eng.output_row(i) is not None
    assert results[13].state == TrackingState.TRACKING


def test_no_pacing_processes_everything():
    o = load_fixture()
    eng = MageSlamTorchFused(_paced(False), fixture_calibration(o), seed=1,
                             device="cpu", busy_fn=lambda: 99)
    for i in range(8):
        eng.process_frame(o["imgs"][i], timestamp=i / 30.0)
    results = eng.flush()
    assert eng.frames_dropped == 0
    assert all(eng.output_row(i) is not None for i in range(8))
    assert len(results) == 8


# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_whole_facade_drive(z):
    """The JAX drive's inputs through the port's facade on the CPU: the
    bootstrap, then the mono frames with the IMU prior and the fuser."""
    from mageslam_tpu_torch.tracking.pose_priors import IMUPosePriorProvider
    prov = IMUPosePriorProvider()
    eng = MageSlamTorchFused(facade_settings(z), stereo_calibration(z),
                             seed=1, device="cpu", pose_prior_provider=prov)
    pair = decode_frames(z["st_pair_dy"])
    eng.process_stereo_frames(pair[0], pair[1], z["st_extrinsics"],
                              timestamp=0.0)
    stream = z["st_imu"]
    fed = 0
    for i, img in enumerate(decode_frames(z["st_mono_dy"])):
        t = float(z["st_ts"][i])
        while fed < len(stream) and stream[fed, 0] <= t + 1e-9:
            ts, ax, ay, az, wx, wy, wz = stream[fed]
            eng.add_sensor_sample(SensorSample.accel(ts, (ax, ay, az)))
            eng.add_sensor_sample(SensorSample.gyro(ts, (wx, wy, wz)))
            prov.add_sample(ts, (wx, wy, wz))
            fed += 1
        eng.process_frame(img, timestamp=t)
        eng.flush()      # the fixture's drive resolves every frame at once
    results = eng.flush()
    tracked = sum(results[i + 1].state == TrackingState.TRACKING
                  for i in range(len(z["st_ts"])))
    assert tracked >= int(z["st_tracked"]) - 3
    g = eng.get_gravity_direction()
    cos = float(np.dot(g, z["st_gravity"]))
    assert np.degrees(np.arccos(min(cos, 1.0))) < 2.0
    assert eng.get_scale() == pytest.approx(float(z["st_scale"]), rel=0.05)
    assert eng.try_get_volume_of_interest() is not None
