"""The port's settings module against the JAX package's.

``mageslam_tpu_torch/config.py`` is the port's own copy of
``mageslam_tpu/config.py``.  These tests keep the two from drifting: same
bags, fields and defaults (compared through the JSON form, exactly), and a
JAX-package settings object crosses over with ``convert.settings_from_jax``
without losing a changed value.
"""

import dataclasses
import json

import pytest

from mageslam_tpu import config as jconfig
from mageslam_tpu_torch import config as tconfig
from mageslam_tpu_torch import convert


def test_defaults_equal_the_jax_package():
    assert tconfig.MageSlamSettings().to_json() \
        == jconfig.MageSlamSettings().to_json()


def test_same_classes_and_enums():
    def public(mod):
        return {n for n, v in vars(mod).items()
                if isinstance(v, type) and v.__module__ == mod.__name__}
    assert public(tconfig) == public(jconfig)
    for name in public(jconfig):
        cj, ct = getattr(jconfig, name), getattr(tconfig, name)
        if dataclasses.is_dataclass(cj):
            assert [(f.name, f.type) for f in dataclasses.fields(ct)] \
                == [(f.name, f.type) for f in dataclasses.fields(cj)], name
        else:   # IntEnum
            assert {m.name: int(m) for m in ct} \
                == {m.name: int(m) for m in cj}, name


def _non_default(mod):
    s = mod.MageSlamSettings()
    cam = s.mono.camera
    cam = dataclasses.replace(cam, features=dataclasses.replace(
        cam.features, num_features=321, fast_threshold=17))
    return s.replace(
        mono=dataclasses.replace(s.mono, camera=cam),
        capacity=dataclasses.replace(s.capacity, max_features=384,
                                     max_map_points=4096),
        loop_closure=dataclasses.replace(s.loop_closure,
                                         enable_loop_closure=False),
        runtime=dataclasses.replace(
            s.runtime, pose_prior=dataclasses.replace(
                s.runtime.pose_prior,
                pose_prior=mod.PosePriorMethod.VISUAL_INERTIAL_FUSION)),
        keyframe=dataclasses.replace(s.keyframe, min_frame_count=3))


def test_settings_from_jax_round_trips_a_non_default_bag():
    sj = _non_default(jconfig)
    st = convert.settings_from_jax(sj)
    assert isinstance(st, tconfig.MageSlamSettings)
    assert type(st.mono.camera.features).__module__ == tconfig.__name__
    assert st == _non_default(tconfig)
    assert st != tconfig.MageSlamSettings()
    assert json.loads(st.to_json()) == json.loads(sj.to_json())
    assert isinstance(st.runtime.pose_prior.pose_prior,
                      tconfig.PosePriorMethod)
    # and back into the JAX package's classes, unchanged
    assert jconfig.MageSlamSettings.from_json(st.to_json()) == sj


@pytest.mark.parametrize("identity", list(tconfig.CameraIdentity))
def test_camera_settings_resolution(identity):
    st, sj = _non_default(tconfig), _non_default(jconfig)
    assert dataclasses.asdict(st.camera_settings(identity)) \
        == dataclasses.asdict(sj.camera_settings(
            jconfig.CameraIdentity(int(identity))))
