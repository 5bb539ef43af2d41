"""Frontend parity: ``extract_features`` of the port against the JAX package
on fixture frames and on the EuRoC-format ``tests/data/mini_seq`` frames.

Exact: ``valid``, ``octave``, ``response`` (the score map and the gridded
top-k are bit-exact).  ``uv`` and ``xn_undist`` within 1e-4 (subpixel
offsets and undistortion are float arithmetic in the same order).
Descriptors: the port's blur differs from the JAX CPU convolution by
float32 reassociation (~1e-4 grey levels), so a BRIEF bit may flip only
where its two sampled intensities lie within 1e-3 of each other in the
JAX run; such near-tie flips are counted and bounded to 0.1% of all bits.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mageslam_tpu.geometry.camera import CameraCalibration as JaxCal
from mageslam_tpu.io import datasets
from mageslam_tpu.ops import orb as jorb
from mageslam_tpu.ops import pyramid as jpyr
from mageslam_tpu.tracking import frontend as jfe
from mageslam_tpu_torch import convert
from mageslam_tpu_torch.ops import orb
from mageslam_tpu_torch.tracking import frontend

torch.set_num_threads(2)
DATA = os.path.join(os.path.dirname(__file__), "data")
FIXTURE = os.path.join(DATA, "torch_orbit60.npz")
NEAR_TIE = 1e-3
MAX_FLIP_FRACTION = 1e-3


def _fixture_frames():
    z = np.load(FIXTURE)
    fx, fy, cx, cy, w, h = z["cal"].tolist()
    cal = JaxCal.pinhole(fx, fy, cx, cy, int(w), int(h))
    return [z["imgs"][i].astype(np.float32) for i in (0, 25, 59)], cal


def _mini_seq_frames():
    seq = datasets.load_dataset(os.path.join(DATA, "mini_seq"))
    cal = seq.tracking_calibration(320)
    imgs = [np.asarray(Image.open(seq.image_paths[i]), np.float32)
            for i in (0, 20)]
    return imgs, cal


def _near_ties(img, cal, feats_j, ksize=7):
    """(K, 256) bool: the JAX run's two BRIEF samples within NEAR_TIE."""
    smooth = jpyr.gaussian_blur(jnp.asarray(img), ksize)
    patches = np.asarray(jorb._extract_patches_bilinear(smooth, feats_j.uv))
    flat = patches.reshape(patches.shape[0], -1)
    pat = jorb._PAT_NP
    r = jorb.PATCH_RADIUS
    i1 = flat[:, (pat[:, 1] + r) * jorb.PATCH + pat[:, 0] + r]
    i2 = flat[:, (pat[:, 3] + r) * jorb.PATCH + pat[:, 2] + r]
    return np.abs(i1 - i2) < NEAR_TIE


def _bits(desc_u32):
    return np.unpackbits(desc_u32.view(np.uint8), bitorder="little") \
        .reshape(desc_u32.shape[0], 256).astype(bool)


def _compare(img, jcal, max_features, threshold):
    fj = jfe.extract_features(jnp.asarray(img), jcal, threshold,
                              max_features=max_features)
    ft = frontend.extract_features(torch.as_tensor(img),
                                   convert.calibration_from_jax(jcal),
                                   threshold, max_features=max_features)
    got = convert.to_numpy(ft)
    np.testing.assert_array_equal(got["valid"], np.asarray(fj.valid))
    np.testing.assert_array_equal(got["octave"], np.asarray(fj.octave))
    np.testing.assert_array_equal(got["response"], np.asarray(fj.response))
    np.testing.assert_allclose(got["uv"], np.asarray(fj.uv), atol=1e-4)
    np.testing.assert_allclose(got["xn_undist"], np.asarray(fj.xn_undist),
                               atol=1e-4)
    flips = _bits(got["desc"]) != _bits(np.asarray(fj.desc))
    ties = _near_ties(img, jcal, fj)
    assert not (flips & ~ties).any(), int((flips & ~ties).sum())
    assert flips.sum() <= MAX_FLIP_FRACTION * flips.size, int(flips.sum())
    assert got["valid"].sum() > 100
    return int(flips.sum())


def test_make_pattern_is_the_jax_pattern():
    np.testing.assert_array_equal(orb._make_pattern(), jorb._PAT_NP)


@pytest.mark.parametrize("max_features", [320, 512])
def test_fixture_frames(max_features):
    imgs, cal = _fixture_frames()
    for img in imgs:
        _compare(img, cal, max_features, 10.0)


def test_mini_seq_frames():
    imgs, cal = _mini_seq_frames()
    for img in imgs:
        _compare(img, cal, 320, 10.0)


def test_extract_for_settings_matches_jax():
    """The settings-driven entry point passes the same knobs as JAX's."""
    from test_torch_engine import fixture_settings
    imgs, cal = _fixture_frames()
    s = fixture_settings("fast")
    F = s.capacity.max_features
    fj = jfe.extract_for_settings(jnp.asarray(imgs[1]), cal, s.mono.camera, F)
    ft = frontend.extract_for_settings(torch.as_tensor(imgs[1]),
                                       convert.calibration_from_jax(cal),
                                       convert.settings_from_jax(s)
                                       .mono.camera, F)
    np.testing.assert_array_equal(ft.valid.numpy(), np.asarray(fj.valid))
    np.testing.assert_array_equal(ft.response.numpy(),
                                  np.asarray(fj.response))
    np.testing.assert_allclose(ft.uv.numpy(), np.asarray(fj.uv), atol=1e-4)
