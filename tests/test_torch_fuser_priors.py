"""Fuser, sensor queue and pose-prior parity: the port against the JAX
package, on the IMU stream and trajectory of ``tests/data/torch_facade.npz``.

Both sides are host code (numpy with float32 quaternions), so the JAX
functions run here directly: quaternion integration and priors within
1e-5, the fuser's mode sequence exact, gravity and scale within 1e-5.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mageslam_tpu.fuser import imu as jimu
from mageslam_tpu.fuser import samples as jsamples
from mageslam_tpu.geometry import se3 as jse3
from mageslam_tpu.tracking import pose_priors as jpriors
from mageslam_tpu_torch.fuser import imu, samples
from mageslam_tpu_torch.geometry import se3
from mageslam_tpu_torch.tracking import pose_priors

FACADE = os.path.join(os.path.dirname(__file__), "data", "torch_facade.npz")


@pytest.fixture(scope="module")
def z():
    return np.load(FACADE)


def _fences(z):
    """Per mono frame: (timestamp, accel (n, 4), gyro (n, 4)) of the
    samples up to it, and its ground-truth pose."""
    stream, ts = z["st_imu"], z["st_ts"]
    out, start = [], 0
    for i, t in enumerate(ts):
        stop = int(np.searchsorted(stream[:, 0], t + 1e-9, side="right"))
        chunk = stream[start:stop]
        out.append((float(t), chunk[:, [0, 1, 2, 3]], chunk[:, [0, 4, 5, 6]],
                    z["st_gt"][i]))
        start = stop
    return out


def test_sample_queue_matches_jax(z):
    stream = z["st_imu"][:50]
    qj = jsamples.SensorSampleQueue(drop_mag=True)
    qt = samples.SensorSampleQueue(drop_mag=True)
    rng = np.random.default_rng(0)
    for k in rng.permutation(len(stream)):
        t, *rest = stream[k]
        for mod, q in ((jsamples, qj), (samples, qt)):
            S = mod.SensorSample
            assert q.add_sample(S.accel(t, rest[:3]))
            assert q.add_sample(S.gyro(t, rest[3:]))
            assert not q.add_sample(S.mag(t, (1.0, 0, 0)))
    for cut in (0.05, 0.1, 1.0):
        aj, gj = qj.split_by_type(qj.drain_until(cut))
        at, gt = qt.split_by_type(qt.drain_until(cut))
        np.testing.assert_array_equal(at, aj)
        np.testing.assert_array_equal(gt, gj)
    assert len(qt) == len(qj) == 0


def test_integration_matches_jax(z):
    fences = _fences(z)
    q = np.array([1.0, 0, 0, 0])
    v = np.zeros(3)
    g = np.array([0.0, -9.80665, 0.0])
    for _, accel, gyro, _ in fences[:10]:
        qj = jimu.integrate_gyro(q, gyro)
        qt = imu.integrate_gyro(q, gyro)
        np.testing.assert_allclose(qt, qj, rtol=0, atol=1e-5)
        pj, vj = jimu.integrate_accel(accel, q, g, v)
        pt, vt = imu.integrate_accel(accel, q, g, v)
        np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)
        np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-5)
        q, v = qj, vj


def test_fuser_mode_machine_matches_jax(z):
    """The drive's fences into both fusers (tracking from frame 2, lost at
    frames 25-26, back at 27): modes exact, gravity and scale within 1e-5."""
    fj, ft = jimu.Fuser(), imu.Fuser()
    modes = []
    for i, (_, accel, gyro, pose) in enumerate(_fences(z)):
        for f in (fj, ft):
            if i >= 2 and i not in (25, 26):
                f.on_mage_initialized()
                f.on_visual_reacquired()
                f.process_fence(accel, gyro, pose)
            elif i in (25, 26):
                f.on_visual_lost()
                f.process_fence(accel, gyro, None)
            else:
                f.process_fence(accel, gyro, None)
        assert ft.mode == fj.mode, i
        modes.append(int(ft.mode))
    assert int(imu.FuserMode.VISUAL_TRACKING_LOST) in modes
    assert ft.mode == imu.FuserMode.TRACKING
    np.testing.assert_allclose(ft.gravity_w, fj.gravity_w, rtol=0, atol=1e-5)
    assert ft.scale == pytest.approx(fj.scale, abs=1e-5)


def test_pose_interpolation_matches_jax(z):
    gt = z["st_gt"]
    pj, pt = jimu.PoseInterpolator(), imu.PoseInterpolator()
    for i in range(0, len(gt), 5):
        pj.add(i / 30.0, gt[i])
        pt.add(i / 30.0, gt[i])
    for t in (-0.1, 0.0, 0.07, 0.33, 0.5, 2.0):
        np.testing.assert_allclose(pt.pose_at(t), np.asarray(pj.pose_at(t)),
                                   rtol=0, atol=1e-5)
    for a in (0.0, 0.3, 1.0):
        np.testing.assert_allclose(
            se3.pose_interpolate(torch.as_tensor(gt[0]),
                                 torch.as_tensor(gt[-1]), a).numpy(),
            np.asarray(jse3.pose_interpolate(jnp.asarray(gt[0]),
                                             jnp.asarray(gt[-1]), a)),
            rtol=0, atol=1e-6)


def test_motion_model_prior_matches_jax(z):
    gt = z["st_gt"]
    pj = jpriors.MotionModelPriorProvider()
    pt = pose_priors.MotionModelPriorProvider()
    assert pt.get_pose_for_time(0.0) is None
    for i in range(8):
        t = i / 30.0
        if i:
            np.testing.assert_allclose(
                pt.get_pose_for_time(t), np.asarray(pj.get_pose_for_time(t)),
                rtol=0, atol=1e-5)
            np.testing.assert_allclose(
                pt.get_pose_for_time(t + 0.02),
                np.asarray(pj.get_pose_for_time(t + 0.02)), rtol=0,
                atol=1e-5)
        pj.on_tracking_pose(t, jnp.asarray(gt[i]))
        pt.on_tracking_pose(t, gt[i])


def test_imu_prior_matches_jax(z):
    """The gyro prior on the drive's stream, anchored every third frame,
    with and without a body-to-camera rotation."""
    rot = np.asarray(jse3.quat_to_mat(jse3.so3_exp(
        jnp.array([0.1, -0.2, 0.05]))))
    b2c = np.eye(4)
    b2c[:3, :3] = rot
    for body_to_camera in (None, b2c):
        pj = jpriors.IMUPosePriorProvider(body_to_camera)
        pt = pose_priors.IMUPosePriorProvider(body_to_camera)
        assert pt.get_pose_for_time(0.0) is None
        for i, (t, _, gyro, pose) in enumerate(_fences(z)):
            for row in gyro:
                pj.add_sample(row[0], row[1:])
                pt.add_sample(row[0], row[1:])
            if i % 3 == 0:
                pj.on_tracking_pose(t, jnp.asarray(pose))
                pt.on_tracking_pose(t, pose)
            else:
                np.testing.assert_allclose(
                    pt.get_pose_for_time(t),
                    np.asarray(pj.get_pose_for_time(t)), rtol=0, atol=1e-5)


def test_stored_priors_are_the_providers(z):
    """The priors the JAX facade handed its engine (``st_priors``) are what
    the port's provider computes from the same samples and poses."""
    prov = pose_priors.IMUPosePriorProvider()
    rows = z["st_rows"]
    stream = z["st_imu"]
    fed = 0
    for i, t in enumerate(z["st_ts"]):
        while fed < len(stream) and stream[fed, 0] <= t + 1e-9:
            prov.add_sample(stream[fed, 0], stream[fed, 4:7])
            fed += 1
        got = prov.get_pose_for_time(float(t))
        want = z["st_priors"][i]
        if np.isnan(want).all():
            assert got is None
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        if int(rows[i, 0]) == 2:          # tracked: the facade's update
            prov.on_tracking_pose(float(t), rows[i, 1:8])


def test_fuser_state_carries_over(z):
    """A JAX fuser stopped mid-way through scale initialization, carried
    into the port (``convert.fuser_from_jax``), finishes as JAX's does."""
    from mageslam_tpu_torch import convert
    fences = _fences(z)
    fj = jimu.Fuser()
    for i, (_, accel, gyro, pose) in enumerate(fences):
        if i == 14:
            ft = convert.fuser_from_jax(fj)
            assert ft.mode == imu.FuserMode.SCALE_INIT
        for f in ((fj,) if i < 14 else (fj, ft)):
            if i >= 2:
                f.on_mage_initialized()
            f.process_fence(accel, gyro, pose if i >= 2 else None)
    assert ft.mode == fj.mode == imu.FuserMode.TRACKING
    np.testing.assert_allclose(ft.gravity_w, fj.gravity_w, rtol=0, atol=1e-5)
    assert ft.scale == pytest.approx(fj.scale, abs=1e-5)
