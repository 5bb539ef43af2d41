"""Multi-level pyramid parity: the port against the JAX package.

Goldens come from ``tests/data/torch_facade.npz``
(``tools/make_torch_facade_fixture.py``); no JAX engine is compiled here.

- Pyramid levels (``build_pyramid``, 3 levels at scale 1.5) of fixture
  frames at 180x320 and 480x752: within 1e-4 grey levels of JAX's.  The
  weights reproduce XLA's CPU arithmetic (``ops/pyramid.resize_weights``);
  the products differ by float32 summation order.
- ``extract_features`` at 2 and 3 levels run on JAX's own level images:
  ``valid``, ``octave``, ``response`` exact; ``uv`` and ``xn_undist`` within
  1e-4; BRIEF bits exact except near-ties (the two sampled intensities
  within 1e-3 in the JAX run, ``tests/test_torch_frontend.py``), at most
  0.1% of the bits.  On the port's own pyramid, at least 99% of JAX's
  keypoints are found again.
- The tracking gates (scale band, octave-scaled radii): exact against the
  JAX expressions of ``mageslam_tpu/tracking/track.py``.
- The whole 60-frame orbit at 2 levels (``-m slow``).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mageslam_tpu.ops import orb as jorb
from mageslam_tpu.ops import pyramid as jpyr
from mageslam_tpu_torch import MageSlamSettings, convert
from mageslam_tpu_torch.geometry.camera import CameraCalibration
from mageslam_tpu_torch.io.evaluation import ate_rmse
from mageslam_tpu_torch.ops import pyramid
from mageslam_tpu_torch.runtime import device_engine as de
from mageslam_tpu_torch.runtime.fused import MageSlamTorchFused
from mageslam_tpu_torch.tracking import frontend, track

torch.set_num_threads(2)
DATA = os.path.join(os.path.dirname(__file__), "data")
FACADE = os.path.join(DATA, "torch_facade.npz")
ORBIT = os.path.join(DATA, "torch_orbit60.npz")
NEAR_TIE = 1e-3
MAX_FLIP_FRACTION = 1e-3
THRESHOLD = 10.0


@pytest.fixture(scope="module")
def z():
    return np.load(FACADE)


@pytest.fixture(scope="module")
def orbit():
    return np.load(ORBIT)


def orbit_calibration(o) -> CameraCalibration:
    fx, fy, cx, cy, w, h = o["cal"].tolist()
    return CameraCalibration.pinhole(fx, fy, cx, cy, int(w), int(h))


def _base(orbit, case):
    frame = orbit["imgs"][int(case[-1])].astype(np.float32)
    if case.startswith("480"):
        frame = np.tile(frame, (3, 3))[:480, :752].copy()
    return frame


@pytest.mark.parametrize("case", ["180_f0", "180_f1", "180_f2", "480_f0"])
def test_pyramid_levels_match_jax(z, orbit, case):
    size, frame = case.split("_")
    levels = pyramid.build_pyramid(torch.as_tensor(_base(orbit, case)), 3,
                                   1.5)
    for lvl in (1, 2):
        want = z[f"lv_{size}_{frame}_l{lvl}"]
        got = levels[lvl].numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4,
                                   err_msg=f"{case} level {lvl}")


@pytest.mark.parametrize("hw", [(180, 320), (480, 752), (37, 61), (8, 9)])
def test_level_shapes_match_jax(hw):
    for lvl in range(4):
        for sf in (1.2, 1.5, 2.0):
            assert pyramid.level_shape(*hw, lvl, sf) \
                == jpyr.level_shape(*hw, lvl, sf)


def _jax_features(z, key):
    prefix = f"lv_feat_{key}/"
    return {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}


def _bits(desc_u32):
    return np.unpackbits(np.ascontiguousarray(desc_u32).view(np.uint8),
                         bitorder="little").reshape(desc_u32.shape[0],
                                                    256).astype(bool)


def _near_ties(levels, fj):
    """(K, 256): the JAX run's two BRIEF samples within NEAR_TIE, each
    keypoint sampled on its own level's blurred image."""
    out = np.zeros((fj["uv"].shape[0], 256), bool)
    r = jorb.PATCH_RADIUS
    pat = jorb._PAT_NP
    for lvl, img in enumerate(levels):
        sel = fj["octave"] == lvl
        smooth = jpyr.gaussian_blur(jnp.asarray(img), 7)
        uv = fj["uv"][sel] / np.float32(1.5 ** lvl)
        patches = np.asarray(jorb._extract_patches_bilinear(
            smooth, jnp.asarray(uv)))
        flat = patches.reshape(patches.shape[0], -1)
        i1 = flat[:, (pat[:, 1] + r) * jorb.PATCH + pat[:, 0] + r]
        i2 = flat[:, (pat[:, 3] + r) * jorb.PATCH + pat[:, 2] + r]
        out[sel] = np.abs(i1 - i2) < NEAR_TIE
    return out


@pytest.mark.parametrize("key", ["f0_n2", "f1_n2", "f2_n2", "f0_n3"])
def test_features_on_jax_levels(z, orbit, key, monkeypatch):
    frame, n = int(key[1]), int(key[-1])
    img = orbit["imgs"][frame].astype(np.float32)
    levels = [img] + [z[f"lv_180_f{frame}_l{lvl}"] for lvl in range(1, n)]
    # the port's frontend reads JAX's level images
    monkeypatch.setattr(pyramid, "build_pyramid", lambda im, num, sf: [
        im] + [torch.as_tensor(lv) for lv in levels[1:]])
    ft = convert.to_numpy(frontend.extract_features(
        torch.as_tensor(img), orbit_calibration(orbit), THRESHOLD,
        max_features=512, num_levels=n, scale_factor=1.5))
    fj = _jax_features(z, key)
    for name in ("valid", "octave", "response"):
        np.testing.assert_array_equal(ft[name], fj[name], err_msg=name)
    for name in ("uv", "xn_undist"):
        np.testing.assert_allclose(ft[name], fj[name], rtol=0, atol=1e-4,
                                   err_msg=name)
    flips = _bits(ft["desc"]) != _bits(fj["desc"])
    ties = _near_ties(levels, fj)
    assert not (flips & ~ties).any(), int((flips & ~ties).sum())
    assert flips.sum() <= MAX_FLIP_FRACTION * flips.size, int(flips.sum())
    for lvl in range(n):
        assert (fj["valid"] & (fj["octave"] == lvl)).sum() >= 10


def test_features_on_own_pyramid_overlap(z, orbit):
    """On the port's own level images (within 1e-4 of JAX's) a FAST score
    can flip only at the threshold: at least 99% of JAX's keypoints are
    found again, at the same level and position."""
    img = orbit["imgs"][0].astype(np.float32)
    ft = convert.to_numpy(frontend.extract_features(
        torch.as_tensor(img), orbit_calibration(orbit), THRESHOLD,
        max_features=512, num_levels=3, scale_factor=1.5))
    fj = _jax_features(z, "f0_n3")
    kj = {(int(o), round(float(u), 3), round(float(v), 3))
          for o, (u, v), ok in zip(fj["octave"], fj["uv"], fj["valid"])
          if ok}
    kt = {(int(o), round(float(u), 3), round(float(v), 3))
          for o, (u, v), ok in zip(ft["octave"], ft["uv"], ft["valid"])
          if ok}
    assert len(kj & kt) >= 0.99 * len(kj), (len(kj & kt), len(kj))


def _jax_gates(pos, max_dist, cam_center, num_levels, sf):
    """The JAX engine's expressions (``mageslam_tpu/tracking/track.py``,
    the scale gate and the octave-scaled radii)."""
    pos, max_dist = jnp.asarray(pos), jnp.asarray(max_dist)
    cam_center = jnp.asarray(cam_center)
    dist_all = jnp.linalg.norm(pos - cam_center, axis=-1)
    dmax = max_dist * 1.25
    dmin = max_dist / (sf ** (num_levels - 1)) * 0.8
    scale_ok = (max_dist <= 0) | ((dist_all >= dmin) & (dist_all <= dmax))
    ratio = max_dist / jnp.maximum(dist_all, 1e-6)
    oct_pred = jnp.clip(
        jnp.round(jnp.log(jnp.maximum(ratio, 1e-6)) / jnp.log(sf)),
        0.0, float(num_levels - 1))
    rad = jnp.where(max_dist > 0, sf ** oct_pred, 1.0)
    return np.asarray(scale_ok), np.asarray(rad)


@pytest.mark.parametrize("num_levels,sf", [(2, 1.5), (3, 1.2), (4, 2.0)])
def test_track_gates_match_jax(num_levels, sf):
    rng = np.random.default_rng(num_levels)
    pos = rng.normal(0, 3, (2000, 3)).astype(np.float32)
    max_dist = (rng.uniform(0.5, 8, 2000)
                * (rng.uniform(size=2000) > 0.1)).astype(np.float32)
    centre = np.array([0.3, -0.2, 0.5], np.float32)
    ok_j, rad_j = _jax_gates(pos, max_dist, centre, num_levels, sf)
    t = torch.as_tensor
    ok_t = track.scale_gate(t(pos), t(max_dist), t(centre), num_levels, sf)
    rad_t = track.search_radius_scale(t(pos), t(max_dist), t(centre),
                                      num_levels, sf)
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    np.testing.assert_array_equal(rad_t.numpy(), rad_j)
    assert 0 < ok_j.sum() < len(ok_j)


@pytest.mark.slow
def test_whole_multilevel_drive(z, orbit):
    """The fixture's 2-level setting over the 60-frame orbit on the CPU:
    tracked within 3 of the JAX engine's count, ATE under its bound."""
    s = MageSlamSettings.from_json(str(z["ml_settings_json"]))
    eng = MageSlamTorchFused(s, orbit_calibration(orbit), seed=1,
                             device="cpu")
    imgs = orbit["imgs"]
    for i, img in enumerate(imgs):
        eng.process_frame(img, timestamp=i / 30.0)
    codes = np.array([eng.output_row(i)[0] for i in range(len(imgs))])
    tracked = int((codes == de.CODE_TRACKING).sum())
    assert tracked >= int(z["ml_tracked"]) - 3
    fossil = eng.fossilize()
    est = [fossil.pose_for_frame(i) for i in range(len(imgs))
           if codes[i] == de.CODE_TRACKING
           and fossil.pose_for_frame(i) is not None]
    gt = [orbit["gt_poses"][i] for i in range(len(imgs))
          if codes[i] == de.CODE_TRACKING
          and fossil.pose_for_frame(i) is not None]
    ate = ate_rmse(np.asarray(est), np.asarray(gt))[0]
    assert ate < float(z["ml_ate_bound"]), (ate, float(z["ml_ate"]))
