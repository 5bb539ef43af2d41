"""The port's camera helpers, ``mat44_to_pose``, ``rpe_stats``, synthetic
renders, device profiles, ``select_topk``, ORB orientations and
descriptors, ``ba_error_px``, the fossil's ``from_engine`` /
``camera_centers`` and checkpoints, against the JAX package on the same
inputs.

Tolerances: calibrations (``scaled``, ``k_matrix``, the focal-length
models, device profiles) exact in float32; renders bit-equal;
``select_topk`` exact; orientations within 1e-6 rad (float32 moment sums
in another order, and XLA's float32 atan2 polynomial); descriptors on the
same angles exact but for BRIEF near-ties (|i1 - i2| < 1e-3 in JAX's
samples); ``project_world`` and ``mat44_to_pose`` 1e-5; ``rpe_stats`` and
``ba_error_px`` 1e-5 relative; checkpoints bit for bit in both directions.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mageslam_tpu import device as jdevice
from mageslam_tpu.geometry import camera as jcam
from mageslam_tpu.geometry import se3 as jse3
from mageslam_tpu.io import evaluation as jeval
from mageslam_tpu.io import serialization as jser
from mageslam_tpu.io import synthetic as jsyn
from mageslam_tpu.mapping import local_ba as jlba
from mageslam_tpu.ops import orb as jorb
from mageslam_tpu.ops import select as jselect
from mageslam_tpu.runtime import device_engine as jde
from mageslam_tpu.solvers.bundle_adjust import BAResult as JaxBAResult
from mageslam_tpu_torch import MageSlamSettings, convert
from mageslam_tpu_torch import device as tdevice
from mageslam_tpu_torch.geometry import camera as tcam
from mageslam_tpu_torch.geometry import se3 as tse3
from mageslam_tpu_torch.io import evaluation as teval
from mageslam_tpu_torch.io import serialization as tser
from mageslam_tpu_torch.io import synthetic as tsyn
from mageslam_tpu_torch.mapping import local_ba as tlba
from mageslam_tpu_torch.ops import orb as torb
from mageslam_tpu_torch.ops import select as tselect
from mageslam_tpu_torch.runtime import device_engine as tde
from mageslam_tpu_torch.runtime.fossilized import FossilizedMap
from mageslam_tpu_torch.solvers.bundle_adjust import BAResult

DATASET = os.path.join(os.path.dirname(__file__), "data",
                       "torch_dataset.npz")


@pytest.fixture(scope="module")
def ds():
    return np.load(DATASET)


def f32(x) -> float:
    return float(np.float32(np.asarray(x)))


def assert_same_calibration(t, j):
    assert [t.fx, t.fy, t.cx, t.cy] == [f32(j.fx), f32(j.fy), f32(j.cx),
                                        f32(j.cy)]
    np.testing.assert_array_equal(t.dist.numpy(), np.asarray(j.dist))
    assert (t.model, t.width, t.height) == (int(j.model), j.width, j.height)


def random_poses(rng, n, spread=0.3):
    return np.asarray(jse3.pose_retract(
        jnp.tile(jse3.pose_identity()[None], (n, 1)),
        jnp.asarray(rng.normal(0, spread, (n, 6)).astype(np.float32))))


# ---------------------------------------------------------------------------
# geometry

@pytest.mark.parametrize("sx,sy", [(320 / 752, 180 / 480), (0.5, 0.5),
                                   (1 / 3, 2 / 3), (1.7, 1.3)])
def test_scaled_calibration_is_jax_float32(sx, sy):
    args = (458.654, 457.296, 367.215, 248.375, -0.28340811, 0.07395907,
            0.00019359, 1.76187114e-05, 0.0, 0.0, 0.0, 0.0, 752, 480)
    j = jcam.CameraCalibration.rational6k(*args).scaled(sx, sy)
    t = tcam.CameraCalibration.rational6k(*args).scaled(sx, sy)
    assert_same_calibration(t, j)
    np.testing.assert_array_equal(t.k_matrix().numpy(),
                                  np.asarray(j.k_matrix()))


def test_project_world_and_mat44_to_pose():
    rng = np.random.default_rng(0)
    jc = jcam.CameraCalibration.poly3k(272.0, 270.0, 160.0, 90.0, -0.2,
                                       0.05, 0.01)
    tc = tcam.CameraCalibration.poly3k(272.0, 270.0, 160.0, 90.0, -0.2,
                                       0.05, 0.01)
    poses = random_poses(rng, 6)
    pts = (rng.normal(0, 1, (6, 50, 3)) + [0, 0, 5]).astype(np.float32)
    uv_j, z_j = jcam.project_world(jc, jnp.asarray(poses)[:, None],
                                   jnp.asarray(pts))
    uv_t, z_t = tcam.project_world(tc, torch.as_tensor(poses)[:, None],
                                   torch.as_tensor(pts))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-5)
    mats = np.asarray(jse3.pose_to_mat44(jnp.asarray(poses)))
    np.testing.assert_allclose(
        tse3.mat44_to_pose(torch.as_tensor(mats)).numpy(),
        np.asarray(jse3.mat44_to_pose(jnp.asarray(mats))), atol=1e-5)


@pytest.mark.parametrize("lens", [0.0, 0.37, 1.25])
def test_linear_focal_length_models(lens):
    jm = jcam.LinearFocalLengthModel(jnp.float32(0.11), jnp.float32(0.83),
                                     jnp.float32(0.51), jnp.float32(0.48))
    tm = tcam.LinearFocalLengthModel(0.11, 0.83, 0.51, 0.48)
    assert_same_calibration(tm.calibration(lens, 320, 180),
                            jm.calibration(jnp.float32(lens), 320, 180))
    jd = jdevice.LinearFocalLengthModel(10.3, 250.1, 10.7, 252.9, 160.2,
                                        90.1)
    td = tdevice.LinearFocalLengthModel(10.3, 250.1, 10.7, 252.9, 160.2,
                                        90.1)
    assert_same_calibration(td.calibration_at(lens), jd.calibration_at(lens))


def test_device_profiles_match_jax():
    assert tdevice.supported_devices() == jdevice.supported_devices()
    for name in jdevice.supported_devices():
        j, t = (m.get_device_profile(name) for m in (jdevice, tdevice))
        assert (t.name, t.imu, t.settings_overrides) == \
            (j.name, tdevice.IMUCharacterization(**vars(j.imu)),
             j.settings_overrides)
        assert_same_calibration(t.calibration, j.calibration)
        np.testing.assert_array_equal(t.imu.body_to_camera_mat(),
                                      j.imu.body_to_camera_mat())
        assert t.imu.gyro_covariance() == j.imu.gyro_covariance()
    assert tdevice.CameraSettings(iso=400) == tdevice.CameraSettings(iso=400)
    with pytest.raises(KeyError, match="unknown"):
        tdevice.get_device_profile("nope")


# ---------------------------------------------------------------------------
# evaluation, synthetic world

def test_rpe_stats_match_jax(ds):
    gt = ds["seq_gt_for_frames"][:16]
    rng = np.random.default_rng(1)
    est = np.array(jse3.pose_retract(
        jnp.asarray(gt), jnp.asarray(rng.normal(0, 2e-3, (len(gt), 6))
                                     .astype(np.float32))))
    est[:, 4:] *= 0.7           # a monocular drive's arbitrary scale
    for delta in (1, 5):
        want = jeval.rpe_stats(est, gt, delta)
        got = teval.rpe_stats(est, gt, delta)
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("make,seed", [("create", 3), ("create_ring", 7),
                                       ("create_planar", 5)])
def test_synthetic_renders_bit_equal(make, seed):
    jw = getattr(jsyn.SyntheticWorld, make)(300, seed=seed)
    tw = getattr(tsyn.SyntheticWorld, make)(300, seed=seed)
    jc, tc = jsyn.default_calibration(), tsyn.default_calibration()
    assert_same_calibration(tc, jc)
    for traj in ("orbit_trajectory", "loop_trajectory"):
        jp, tp = (getattr(m, traj)(4) for m in (jsyn, tsyn))
        np.testing.assert_array_equal(tp, jp)
        for i, p in enumerate(jp):
            img_j, dep_j = jw.render(jc, p, seed=i, return_depth=True)
            img_t, dep_t = tw.render(tc, p, seed=i, return_depth=True)
            np.testing.assert_array_equal(img_t, img_j)
            np.testing.assert_array_equal(dep_t, dep_j)
    np.testing.assert_array_equal(tsyn.occlusion_frame(tc, seed=4),
                                  jsyn.occlusion_frame(jc, seed=4))


# ---------------------------------------------------------------------------
# selection and ORB

@pytest.fixture(scope="module")
def frame():
    w = jsyn.SyntheticWorld.create(500, seed=3)
    return w.render(jsyn.default_calibration(),
                    jsyn.orbit_trajectory(3)[1], seed=11)


def test_select_topk_exact(frame):
    score = np.where(frame > 120, frame - 120, 0).astype(np.float32)
    score[::7, ::5] = 42.0          # ties, broken by the lowest index
    for k in (64, 512):
        j = jselect.select_topk(jnp.asarray(score), k)
        t = tselect.select_topk(torch.as_tensor(score), k)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_orientations_and_descriptors(frame):
    rng = np.random.default_rng(2)
    uv = np.stack([rng.integers(0, 320, 300), rng.integers(0, 180, 300)],
                  -1).astype(np.float32)
    ang_j = np.asarray(jorb.compute_orientations(jnp.asarray(frame),
                                                 jnp.asarray(uv)))
    ang_t = torb.compute_orientations(torch.as_tensor(frame),
                                      torch.as_tensor(uv)).numpy()
    # the moments are float32 sums in another order, and XLA's float32
    # atan2 is a polynomial that differs from the correctly rounded value
    # (and from torch's) in the last bit of 16% of its results
    np.testing.assert_allclose(ang_t, ang_j, rtol=0, atol=1e-6)
    patches = np.asarray(jorb._extract_patches(jnp.asarray(frame),
                                               jnp.asarray(uv)))
    pat = np.asarray(jorb.BRIEF_PATTERN) + jorb.PATCH_RADIUS
    for orient in (False, True):
        dj = np.asarray(jorb.compute_descriptors(
            jnp.asarray(frame), jnp.asarray(uv), jnp.asarray(ang_j),
            use_orientation=orient))
        dt = torb.compute_descriptors(
            torch.as_tensor(frame), torch.as_tensor(uv),
            torch.as_tensor(ang_j), use_orientation=orient).numpy()
        bits = np.unpackbits(dj.view(np.uint8), axis=1, bitorder="little") \
            != np.unpackbits(dt.view(np.uint8), axis=1, bitorder="little")
        if not orient:
            # the unrotated pattern: a tie can only come from equal samples
            near = np.abs(patches[:, pat[:, 1], pat[:, 0]]
                          - patches[:, pat[:, 3], pat[:, 2]]) < 1e-3
            assert not (bits & ~near).any()
        assert bits.mean() <= 1e-3


def test_ba_error_px():
    r = dict(kf_poses=np.zeros((1, 7), np.float32),
             points=np.zeros((1, 3), np.float32),
             mean_sq_error=np.float32(3.7e-6), lam=np.float32(1e-3),
             outliers=np.zeros((1, 1), bool), num_inlier_obs=np.int32(9))
    want = jlba.ba_error_px(JaxBAResult(**{k: jnp.asarray(v)
                                           for k, v in r.items()}), 272.0)
    got = tlba.ba_error_px(BAResult(**{k: torch.as_tensor(v)
                                       for k, v in r.items()}), 272.0)
    assert got == pytest.approx(want, rel=1e-5)


# ---------------------------------------------------------------------------
# fossil and checkpoints

def test_fossil_from_engine_and_camera_centers(ds):
    eng = type("Facade", (), {})()
    st = convert.engine_state_from_npz(ds, "cs_state/")
    eng.map_state, eng.state = st.map, st
    fossil = FossilizedMap.from_engine(eng)
    assert len(fossil.frame_ids) >= 2
    np.testing.assert_allclose(
        fossil.camera_centers(),
        np.asarray(jse3.camera_center(jnp.asarray(fossil.poses))),
        atol=1e-5)


def jax_template(ds):
    from mageslam_tpu.config import MageSlamSettings as JaxSettings
    return jde.empty_state(JaxSettings.from_json(
        str(ds["con_settings_json"])))


def leaves(prefix, obj, out):
    if hasattr(obj, "_fields"):
        for name in obj._fields:
            leaves(f"{prefix}{name}/", getattr(obj, name), out)
    else:
        a = obj.numpy() if torch.is_tensor(obj) else np.asarray(obj)
        out[prefix.rstrip("/")] = a
    return out


def assert_state_equals_npz(st, ds):
    got = leaves("", st, {})
    want = {k[len("cs_state/"):]: ds[k] for k in ds.files
            if k.startswith("cs_state/")}
    assert set(got) == set(want) - {"key"}
    for k, a in got.items():
        b = want[k]
        if b.dtype == np.uint32:
            b = b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=k)
        assert a.dtype == b.dtype, k


def test_jax_checkpoint_loads_in_the_port(ds, tmp_path):
    path = tmp_path / "jax.npz"
    path.write_bytes(ds["ckpt_bytes"].tobytes())
    settings = MageSlamSettings.from_json(str(ds["con_settings_json"]))
    st = tser.load_state(str(path), tde.empty_state(settings, "cpu"))
    assert_state_equals_npz(st, ds)


def test_port_checkpoint_loads_in_jax_and_round_trips(ds, tmp_path):
    st = convert.engine_state_from_npz(ds, "cs_state/")
    path = tmp_path / "port.npz"
    tser.save_state(str(path), st, {"frame": int(ds["cs_frame"])})
    # the port's own round trip, bit for bit
    settings = MageSlamSettings.from_json(str(ds["con_settings_json"]))
    assert_state_equals_npz(
        tser.load_state(str(path), tde.empty_state(settings, "cpu")), ds)
    # JAX's loader: every leaf equal, the key the template's default
    js = jser.load_state(str(path), jax_template(ds))
    want = {k[len("cs_state/"):]: ds[k] for k in ds.files
            if k.startswith("cs_state/")}
    got = leaves("", js._replace(key=None), {})
    for k, b in want.items():
        np.testing.assert_array_equal(got[k], b, err_msg=k)
        assert got[k].dtype == b.dtype, k
    import jax
    np.testing.assert_array_equal(jax.random.key_data(js.key),
                                  jax.random.key_data(jax.random.key(0)))


def test_older_checkpoint_fills_template_fields(ds, tmp_path):
    """A checkpoint without a field (an older format) keeps the template's
    value there; a newer format is refused."""
    st = convert.engine_state_from_npz(ds, "cs_state/")
    path = tmp_path / "old.npz"
    tser.save_state(str(path), st)
    data = dict(np.load(path))
    del data["map/mp_octave"]
    np.savez(path, **data)
    settings = MageSlamSettings.from_json(str(ds["con_settings_json"]))
    tpl = tde.empty_state(settings, "cpu")
    got = tser.load_state(str(path), tpl)
    assert torch.equal(got.map.mp_octave, tpl.map.mp_octave)
    assert torch.equal(got.map.mp_pos, st.map.mp_pos)
    data["__meta__"] = np.frombuffer(b'{"format_version": 3}', np.uint8)
    np.savez(path, **data)
    with pytest.raises(ValueError, match="newer"):
        tser.load_state(str(path), tpl)
