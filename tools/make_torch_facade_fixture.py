"""Write tests/data/torch_facade.npz: the JAX package's goldens for the
multi-level pyramid, pixel undistortion, stereo bootstrap, IMU fuser, pose
priors, volume of interest and the facade's events.

The PyTorch port is held against the JAX package, and ``chip_smoke.py``
drives the port on a GPU host that has no JAX, so both read this file.
Frames are stored as row differences (mod 256), as
``tools/make_torch_ring_fixture.py`` does.  It holds:

- ``ml_*``: the JAX fused engine over ``torch_orbit60.npz``'s 60 frames at
  ``chip_smoke.ref_settings()`` with ``num_levels=2``, ``scale_factor=1.5``
  (the setting of ``tests/test_multilevel.py``): rows, tracked count, the
  Sim3-aligned ATE of the fossilized trajectory and its 1.5x bound, the
  settings as JSON;
- ``lv_*``: ``build_pyramid`` levels 1 and 2 (3 levels, scale 1.5) of
  orbit frames 0-2 at 180x320 and of frame 0 tiled to 480x752, and the JAX
  frontend's features of frames 0-2 at 2 levels and of frame 0 at 3;
- ``st_*``: a stereo rig (the world and 0.11 m baseline of
  ``tests/test_api_parity.py``) and 30 following mono frames with ground
  truth, a 200 Hz IMU stream synthesised along the trajectory, the
  settings (``fast_settings()`` with stereo init and the fuser on) as
  JSON; the JAX pair features and ``stereo_initialize`` result; the JAX
  facade's drive (an ``IMUPosePriorProvider`` fed the gyro samples,
  ``add_sensor_sample`` fed the stream, ``flush()`` after every frame so
  that results resolve before the next frame, as the port's do): rows,
  priors handed to the engine, mediator events, determinism streams, the
  fuser's mode after each frame, gravity, scale, map after the bootstrap,
  volume of interest; the engine state after mono frame ``CS_FRAME``
  (``cs_state/*``) for a carried-state window;
- ``nf_*``: the same drive at the facade's default ``fetch_every`` (8)
  with no ``flush()`` between frames, so that results, priors, events and
  fuser fences follow the fetch ring: rows, priors handed to the engine,
  frames resolved at each call, events, fuser modes after each call,
  tracked count, gravity, scale, keyframes, map points and the volume of
  interest;
- ``ud_*``: a distorted (poly3k) calibration, orbit frame 0 warped through
  it, and the JAX ``extract_for_settings`` output with
  ``undistort_image_pixels`` on.

Run from the repository root (about 8 minutes on 8 CPU cores):

    JAX_PLATFORMS=cpu python tools/make_torch_facade_fixture.py

Name parts (``facade_drive_no_flush``, ...) to recompute only those and
keep the file's other keys.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT / "tools"))
OUT = ROOT / "tests" / "data" / "torch_facade.npz"
ORBIT = ROOT / "tests" / "data" / "torch_orbit60.npz"
N_MONO = 30
CS_FRAME = 12          # mono frame after which the state is carried over
CS_WINDOW = 7
IMU_HZ = 200.0
BASELINE = 0.11
STEREO_TARGET = (0.0, 0.0, 1.4)


def encode_frames(imgs: np.ndarray) -> np.ndarray:
    return np.diff(imgs, axis=1, prepend=np.uint8(0)).astype(np.uint8)


def decode_frames(dy: np.ndarray) -> np.ndarray:
    return np.cumsum(dy, axis=1, dtype=np.uint8)


def multilevel_settings():
    """``chip_smoke.ref_settings()`` (bench's reference shape, loop
    closure on) with two pyramid levels at scale 1.5."""
    from bench import ref_settings
    s = ref_settings()
    fe = dataclasses.replace(s.mono.camera.features, num_levels=2,
                             scale_factor=1.5)
    cam = dataclasses.replace(s.mono.camera, features=fe)
    return s.replace(mono=dataclasses.replace(s.mono, camera=cam))


def facade_settings():
    from test_slam_e2e import fast_settings
    s = fast_settings()
    return s.replace(
        stereo=dataclasses.replace(s.stereo, use_stereo_init=True),
        fuser=dataclasses.replace(s.fuser, use_fuser=True))


def distorted_calibration():
    from mageslam_tpu.geometry.camera import CameraCalibration
    return CameraCalibration.poly3k(272.0, 272.0, 160.0, 90.0,
                                    -0.28, 0.07, 0.0, 320, 180)


def look_at(c, target=STEREO_TARGET) -> np.ndarray:
    """(7,) view pose of a camera at ``c`` looking at ``target``, y up."""
    from mageslam_tpu.io.synthetic import _mat_to_quat_np
    fwd = np.asarray(target, np.float64) - c
    fwd /= np.linalg.norm(fwd)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    rcw = np.stack([right, up, fwd])
    return np.concatenate([_mat_to_quat_np(rcw), -rcw @ c])


def centre(t: float) -> np.ndarray:
    """Camera centre of the mono drive at time t (s); at rest at t = 0."""
    a = 0.5 * (1.0 - np.cos(np.pi * t))
    return np.array([-0.16 * a, 0.04 * np.sin(np.pi * t) * a, 0.06 * a])


class Recorder:
    """Mediator listener: every event as (kind, frame, fields)."""

    def __init__(self, mediator):
        from mageslam_tpu.utils.mediator import (AnalysisCompleted,
                                                 PoseRefined, TrackingLost)
        self.events = []
        mediator.subscribe(AnalysisCompleted, lambda e: self.events.append(
            (0, e.frame_id, e.num_features, 0, 0)))
        mediator.subscribe(PoseRefined, lambda e: self.events.append(
            (1, e.frame_id, int(e.is_keyframe), e.num_inliers, 0)))
        mediator.subscribe(TrackingLost, lambda e: self.events.append(
            (2, e.frame_id, e.consecutive_failures, 0, 0)))


def state_leaves(st, prefix: str) -> dict:
    from make_torch_fixture import _state_leaves
    return {prefix + k: np.array(v, copy=True)
            for k, v in _state_leaves(st).items()}


def features_dict(f, prefix: str) -> dict:
    return {f"{prefix}{k}": np.asarray(v) for k, v in f._asdict().items()}


def multilevel_drive(out: dict):
    from mageslam_tpu.io.evaluation import ate_rmse
    from mageslam_tpu.runtime import device_engine as de
    from mageslam_tpu.runtime.fused import MageSlamTPUFused
    from mageslam_tpu.runtime.slam import TrackingState
    from make_torch_fixture import _RowRecorder

    z = np.load(ORBIT)
    cal = orbit_calibration(z)
    s = multilevel_settings()
    rec = _RowRecorder()
    eng = MageSlamTPUFused(s, cal, seed=1, fetch_every=1, determinator=rec)
    imgs = z["imgs"]
    for i, img in enumerate(imgs):
        eng.process_frame(img, timestamp=i / 30.0)
    results = eng.flush()
    fossil = eng.fossilize()
    rows = np.stack([rec.rows[i] for i in range(len(imgs))])
    est, gt = [], []
    for i in range(len(imgs)):
        p = fossil.pose_for_frame(i)
        if results[i].state == TrackingState.TRACKING and p is not None:
            est.append(p)
            gt.append(z["gt_poses"][i])
    ate = float(ate_rmse(np.asarray(est), np.asarray(gt))[0])
    tracked = int((rows[:, 0] == de.CODE_TRACKING).sum())
    out.update(ml_settings_json=np.array(s.to_json()), ml_rows=rows,
               ml_tracked=np.int64(tracked), ml_ate=np.float64(ate),
               ml_ate_bound=np.float64(1.5 * ate))
    print(f"multi-level orbit: tracked {tracked}/{len(imgs)}, ATE "
          f"{ate:.5f}", flush=True)


def orbit_calibration(z):
    from mageslam_tpu.geometry.camera import CameraCalibration
    fx, fy, cx, cy, w, h = z["cal"].tolist()
    return CameraCalibration.pinhole(fx, fy, cx, cy, int(w), int(h))


def levels_and_features(out: dict):
    import jax.numpy as jnp
    from mageslam_tpu.ops import pyramid
    from mageslam_tpu.tracking.frontend import extract_features

    z = np.load(ORBIT)
    cal = orbit_calibration(z)
    fe = multilevel_settings().mono.camera.features
    F = 512
    for k in range(3):
        img = z["imgs"][k].astype(np.float32)
        lv = pyramid.build_pyramid(jnp.asarray(img), 3, 1.5)
        out[f"lv_180_f{k}_l1"] = np.asarray(lv[1])
        out[f"lv_180_f{k}_l2"] = np.asarray(lv[2])
        for n in ((2, 3) if k == 0 else (2,)):
            f = extract_features(
                jnp.asarray(img), cal, float(fe.fast_threshold),
                max_features=F, num_levels=n, scale_factor=1.5,
                gaussian_ksize=int(fe.gaussian_kernel_size))
            out.update(features_dict(f, f"lv_feat_f{k}_n{n}/"))
    big = np.tile(z["imgs"][0].astype(np.float32), (3, 3))[:480, :752]
    lv = pyramid.build_pyramid(jnp.asarray(big), 3, 1.5)
    out["lv_480_f0_l1"] = np.asarray(lv[1])
    out["lv_480_f0_l2"] = np.asarray(lv[2])


def undistortion(out: dict):
    import jax.numpy as jnp
    from mageslam_tpu.geometry.camera import undistort_normalized
    from mageslam_tpu.ops import undistort
    from mageslam_tpu.tracking.frontend import extract_for_settings

    z = np.load(ORBIT)
    cal = distorted_calibration()
    pin = z["imgs"][0]
    h, w = pin.shape
    v, u = np.mgrid[0:h, 0:w]
    xd = np.stack([(u - 160.0) / 272.0, (v - 90.0) / 272.0],
                  -1).astype(np.float32)
    xn = np.asarray(undistort_normalized(
        cal, jnp.asarray(xd.reshape(-1, 2)))).reshape(h, w, 2)
    gx = np.clip(xn[..., 0] * 272.0 + 160.0, 0, w - 1)
    gy = np.clip(xn[..., 1] * 272.0 + 90.0, 0, h - 1)
    img = pin[gy.round().astype(int), gx.round().astype(int)]
    s = facade_settings()
    cam = dataclasses.replace(s.mono.camera, undistort_image_pixels=True)
    F = s.capacity.max_features
    f = extract_for_settings(jnp.asarray(img.astype(np.float32)), cal, cam,
                             F)
    out.update(features_dict(f, "ud_feat/"))
    out["ud_img"] = img.astype(np.uint8)
    out["ud_rectified"] = np.asarray(undistort.undistort_image(
        jnp.asarray(img.astype(np.float32)), cal))
    out["ud_cal"] = np.array([272.0, 272.0, 160.0, 90.0, 320, 180],
                             np.float64)
    out["ud_cal_dist"] = np.asarray(cal.dist, np.float32)
    out["ud_cal_model"] = np.int64(int(np.asarray(cal.model)))
    print(f"rectified frontend: {int(f.count)} features", flush=True)


def stereo_world():
    """Pair images, mono images, ground truth, timestamps, extrinsics."""
    from mageslam_tpu.io.synthetic import (SyntheticWorld,
                                           default_calibration)
    world = SyntheticWorld.create(700, seed=3, extent=(1.2, 0.8, 0.5),
                                  center=STEREO_TARGET)
    cal = default_calibration()
    extr = np.array([1.0, 0, 0, 0, -BASELINE, 0, 0], np.float32)

    def render(pose, seed):
        return np.clip(world.render(cal, pose, seed=seed), 0,
                       255).astype(np.uint8)

    ident = np.array([1.0, 0, 0, 0, 0, 0, 0], np.float32)
    pair = np.stack([render(ident, 1), render(extr, 2)])
    ts = np.arange(1, N_MONO + 1) / 30.0
    gt = np.stack([look_at(centre(t)) for t in ts]).astype(np.float32)
    mono = np.stack([render(p, 600 + i) for i, p in enumerate(gt)])
    return cal, extr, pair, mono, gt, ts


def imu_stream(t_end: float):
    """(N, 7) samples (t, ax, ay, az, wx, wy, wz) at IMU_HZ from 0 to
    t_end: body rates and specific force of the camera along ``centre``.
    A body-frame rate w over dt turns the view rotation q into
    conj(exp(w dt)) * q, which is how the fuser and the IMU prior
    integrate it."""
    from mageslam_tpu.geometry import se3
    import jax.numpy as jnp
    g_w = np.array([0.0, -9.80665, 0.0])
    dt = 1.0 / IMU_HZ
    n = int(round(t_end * IMU_HZ)) + 1
    out = []
    for i in range(n):
        t = i * dt
        q0 = look_at(centre(t))[:4]
        q1 = look_at(centre(t + dt))[:4]
        dq = se3.quat_mul(jnp.asarray(q0, jnp.float32),
                          se3.quat_conj(jnp.asarray(q1, jnp.float32)))
        w = np.asarray(se3.so3_log(dq), np.float64) / dt
        h = 1e-3
        a_w = (centre(t + h) - 2 * centre(t) + centre(t - h)) / (h * h)
        rcw = np.asarray(se3.quat_to_mat(jnp.asarray(q0, jnp.float32)),
                         np.float64)
        out.append([t, *(rcw @ (a_w + g_w)), *w])
    return np.asarray(out, np.float64)


def facade_drive(out: dict):
    import jax.numpy as jnp
    from mageslam_tpu.fuser.samples import SensorSample
    from mageslam_tpu.runtime.fused import MageSlamTPUFused
    from mageslam_tpu.runtime.slam import TrackingState
    from mageslam_tpu.tracking import stereo
    from mageslam_tpu.tracking.frontend import extract_for_settings
    from mageslam_tpu.tracking.pose_priors import IMUPosePriorProvider
    from mageslam_tpu.utils.determinism import Determinator
    from make_torch_fixture import _RowRecorder

    cal, extr, pair, mono, gt, ts = stereo_world()
    imu = imu_stream(float(ts[-1]))
    s = facade_settings()
    F = s.capacity.max_features
    f1, f2 = (extract_for_settings(jnp.asarray(im.astype(np.float32)), cal,
                                   s.mono.camera, F) for im in pair)
    res = stereo.stereo_initialize(f1, f2, jnp.asarray(extr),
                                   s.stereo.map_init, float(cal.fx))
    out.update(features_dict(f1, "st_f1/"))
    out.update(features_dict(f2, "st_f2/"))
    out.update({f"st_res/{k}": np.asarray(v)
                for k, v in res._asdict().items()})

    class Priors(IMUPosePriorProvider):
        """Records what the provider hands the engine."""

        def __init__(self):
            super().__init__()
            self.given = {}

        def get_pose_for_time(self, timestamp):
            p = super().get_pose_for_time(timestamp)
            self.given[round(timestamp * 30)] = p
            return p

    prov = Priors()
    rows = _RowRecorder()
    det = Determinator()

    class Both:
        def check(self, name, fid, *values):
            rows.check(name, fid, *values)
            det.check(name, fid, *values)

    eng = MageSlamTPUFused(s, cal, seed=1, fetch_every=1,
                           pose_prior_provider=prov, determinator=Both())
    events = Recorder(eng.mediator)
    r1, r2 = eng.process_stereo_frames(pair[0], pair[1], extr, timestamp=0.0)
    m = eng.map_state
    pts = np.asarray(m.mp_pos)[np.asarray(m.mp_valid)]
    out.update(st_pair_states=np.array([r1.state.value, r2.state.value]),
               st_pair_poses=np.stack([r1.pose, r2.pose]).astype(np.float32),
               st_map_points=np.int64(len(pts)),
               st_median_depth=np.float64(np.median(pts[:, 2])),
               st_keyframes=np.int64(eng.num_keyframes))
    print(f"stereo bootstrap: {r1.state.value}/{r2.state.value}, "
          f"{len(pts)} map points, median depth "
          f"{np.median(pts[:, 2]):.4f}", flush=True)
    fed = 0
    modes, priors = [], []
    for i, img in enumerate(mono):
        fid = i + 1
        while fed < len(imu) and imu[fed, 0] <= ts[i] + 1e-9:
            t, ax, ay, az, wx, wy, wz = imu[fed]
            eng.add_sensor_sample(SensorSample.accel(t, (ax, ay, az)))
            eng.add_sensor_sample(SensorSample.gyro(t, (wx, wy, wz)))
            prov.add_sample(t, (wx, wy, wz))
            fed += 1
        eng.process_frame(img, timestamp=float(ts[i]))
        eng.flush()
        modes.append(int(eng._fuser.mode))
        p = prov.given.get(fid)
        priors.append(np.full(7, np.nan, np.float32) if p is None
                      else np.asarray(p, np.float32))
        if i + 1 == CS_FRAME:
            out.update(state_leaves(eng._state, "cs_state/"))
    results = eng.flush()
    out["st_rows"] = np.stack([rows.rows[i + 1] for i in range(N_MONO)])
    tracked = sum(results[i + 1].state == TrackingState.TRACKING
                  for i in range(N_MONO))
    g = eng.get_gravity_direction()
    sc = eng.get_scale()
    voi = eng.try_get_volume_of_interest()
    out.update(
        st_settings_json=np.array(s.to_json()), st_pair_dy=encode_frames(
            pair), st_mono_dy=encode_frames(mono), st_gt=gt,
        st_ts=ts.astype(np.float64), st_extrinsics=extr, st_imu=imu,
        st_cal=np.array([cal.fx, cal.fy, cal.cx, cal.cy, cal.width,
                         cal.height], np.float64),
        st_tracked=np.int64(tracked), st_modes=np.array(modes, np.int64),
        st_priors=np.stack(priors),
        st_gravity=np.asarray(g if g is not None else np.full(3, np.nan)),
        st_scale=np.float64(sc if sc is not None else np.nan),
        st_voi=np.stack([voi.min_corner, voi.max_corner]).astype(np.float64)
        if voi is not None else np.full((2, 3), np.nan),
        st_events=np.array(events.events, np.int64),
        st_det_names=np.array(sorted(det.streams)),
        st_det=np.array([det.streams[k] for k in sorted(det.streams)],
                        np.int64),
        cs_frame=np.int64(CS_FRAME), cs_window=np.int64(CS_WINDOW))
    print(f"facade: tracked {tracked}/{N_MONO}, fuser modes {modes}, "
          f"gravity {g}, scale {sc}, VOI "
          f"{None if voi is None else (voi.min_corner, voi.max_corner)}, "
          f"{len(events.events)} events", flush=True)


def facade_drive_no_flush(out: dict):
    from mageslam_tpu.fuser.samples import SensorSample
    from mageslam_tpu.runtime.fused import MageSlamTPUFused
    from mageslam_tpu.runtime.slam import TrackingState
    from mageslam_tpu.tracking.pose_priors import IMUPosePriorProvider
    from make_torch_fixture import _RowRecorder

    cal, extr, pair, mono, _, ts = stereo_world()
    imu = imu_stream(float(ts[-1]))
    prov = IMUPosePriorProvider()
    given = []
    ask = prov.get_pose_for_time

    def get_pose_for_time(timestamp):
        p = ask(timestamp)
        given.append(np.full(7, np.nan, np.float32) if p is None
                     else np.asarray(p, np.float32))
        return p
    prov.get_pose_for_time = get_pose_for_time
    rows = _RowRecorder()
    eng = MageSlamTPUFused(facade_settings(), cal, seed=1,
                           pose_prior_provider=prov, determinator=rows)
    events = Recorder(eng.mediator)
    eng.process_stereo_frames(pair[0], pair[1], extr, timestamp=0.0)
    fed, modes, resolved, seen = 0, [], [], set(eng._results)
    for i, img in enumerate(mono):
        while fed < len(imu) and imu[fed, 0] <= ts[i] + 1e-9:
            t, ax, ay, az, wx, wy, wz = imu[fed]
            eng.add_sensor_sample(SensorSample.accel(t, (ax, ay, az)))
            eng.add_sensor_sample(SensorSample.gyro(t, (wx, wy, wz)))
            prov.add_sample(t, (wx, wy, wz))
            fed += 1
        eng.process_frame(img, timestamp=float(ts[i]))
        modes.append(int(eng._fuser.mode))
        resolved.append(len(set(eng._results) - seen))
        seen = set(eng._results)
    results = eng.flush()
    tracked = sum(results[i + 1].state == TrackingState.TRACKING
                  for i in range(N_MONO))
    g, sc = eng.get_gravity_direction(), eng.get_scale()
    voi = eng.try_get_volume_of_interest()
    out.update(
        nf_voi=np.stack([voi.min_corner, voi.max_corner]).astype(np.float64)
        if voi is not None else np.full((2, 3), np.nan),
        nf_keyframes=np.int64(eng.num_keyframes),
        nf_map_points=np.int64(eng.num_map_points),
        nf_rows=np.stack([rows.rows[i + 1] for i in range(N_MONO)]),
        nf_priors=np.stack(given), nf_resolved=np.array(resolved, np.int64),
        nf_events=np.array(events.events, np.int64),
        nf_modes=np.array(modes, np.int64), nf_tracked=np.int64(tracked),
        nf_gravity=np.asarray(g if g is not None else np.full(3, np.nan)),
        nf_scale=np.float64(sc if sc is not None else np.nan))
    print(f"facade, no flush: tracked {tracked}/{N_MONO}, resolved per "
          f"call {resolved}, fuser modes {modes}, gravity {g}, scale {sc}, "
          f"{eng.num_keyframes} keyframes, {eng.num_map_points} map points, "
          f"VOI {out['nf_voi'].tolist()}", flush=True)


PARTS = (levels_and_features, undistortion, facade_drive,
         facade_drive_no_flush, multilevel_drive)


def main(names):
    import jax
    jax.config.update("jax_platforms", "cpu")
    parts = [p for p in PARTS if p.__name__ in names] if names else PARTS
    if len(parts) != len(names or PARTS):
        raise SystemExit(f"parts: {[p.__name__ for p in PARTS]}")
    out = dict(np.load(OUT)) if names else {}
    for part in parts:
        t0 = time.perf_counter()
        part(out)
        print(f"{part.__name__}: {time.perf_counter() - t0:.0f} s",
              flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size / 1e6:.2f} MB)")


if __name__ == "__main__":
    main(sys.argv[1:])
