"""The slice as a whole: the port's fused engine against the JAX engine.

Goldens come from ``tests/data/torch_orbit60.npz`` (written by
``tools/make_torch_fixture.py`` from the JAX engine on the CPU; the JAX
package is frozen, so they cannot go stale): the bench's 60-frame orbit,
the JAX engine's per-frame output rows under ``fast_settings()`` with loop
closure off, and its ``EngineState`` right after the frame whose
third-frame confirmation passed.

(a) Carried-state window: that state is carried over with ``convert.py``
    and both engines step the next frames.  After initialization neither
    engine draws a random number, so per-frame code, keyframe flag,
    keyframe and map-point counts and the integer association
    fingerprints (output slots 17 and 19) must match exactly; poses within
    1e-3.  BoW signatures are left out: the vocabulary trained inside the
    window comes from each engine's own RNG, and nothing in this slice
    reads the signatures.
(b) Whole drive from an empty state, each engine with its own RNG: both
    initialize, tracked counts within 2, the port's Sim3-aligned ATE within
    1.5x the JAX engine's.
(c) Guardrails: the parallel layer's settings raise, the lost branch
    runs a relocalization instead of raising, and an entry point built
    without a device argument raises where there is no CUDA card.

The engine runs on the card by default, so every construction here asks for
``device="cpu"``; settings made by the JAX package's helpers reach the port
through ``convert.settings_from_jax``.
"""

import dataclasses
import os
import sys
import types

import numpy as np
import pytest
import torch

from mageslam_tpu_torch import convert
from mageslam_tpu_torch.geometry.camera import CameraCalibration
from mageslam_tpu_torch.io.evaluation import ate_rmse
from mageslam_tpu_torch.mapstore import volume_of_interest
from mageslam_tpu_torch.runtime import device_engine as de
from mageslam_tpu_torch.runtime.fused import MageSlamTorchFused
from mageslam_tpu_torch.runtime.results import TrackingState
from mageslam_tpu_torch.runtime.slam import MageSlamTorch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_torch_fixture import fixture_settings  # noqa: E402

torch.set_num_threads(2)
FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "torch_orbit60.npz")
WINDOW = 12


def port_settings(name: str):
    """``fixture_settings(name)`` as the port's own settings object."""
    return convert.settings_from_jax(fixture_settings(name))


def load_fixture():
    return np.load(FIXTURE)


def fixture_calibration(z) -> CameraCalibration:
    fx, fy, cx, cy, w, h = z["cal"].tolist()
    return CameraCalibration.pinhole(fx, fy, cx, cy, int(w), int(h))


def jax_state_namespace(z, prefix="fast_state/"):
    """Nested attribute view of the stored JAX EngineState leaves."""
    root = types.SimpleNamespace()
    for key in z.files:
        if not key.startswith(prefix):
            continue
        node = root
        *parents, leaf = key[len(prefix):].split("/")
        for p in parents:
            if not hasattr(node, p):
                setattr(node, p, types.SimpleNamespace())
            node = getattr(node, p)
        setattr(node, leaf, z[key])
    return root


@pytest.fixture(scope="module")
def fixture():
    return load_fixture()


def test_carried_state_window(fixture):
    z = fixture
    start = int(z["fast_state_frame"])
    st = convert.engine_state_from_jax(jax_state_namespace(z))
    eng = de.DeviceEngine(port_settings("fast"), fixture_calibration(z),
                          device="cpu", seed=0)
    rows_j = z["fast_rows"]
    rows_t = []
    for i in range(start + 1, start + 1 + WINDOW):
        st, out = eng.step(st, torch.as_tensor(z["imgs"][i]), i / 30.0, i)
        rows_t.append(out.numpy())
    rows_t = np.stack(rows_t)
    rj = rows_j[start + 1:start + 1 + WINDOW]
    # code, keyframe flag, keyframe / map-point counts, assoc fingerprints
    for col in (0, 12, 9, 10, 17, 19):
        np.testing.assert_array_equal(rows_t[:, col], rj[:, col],
                                      err_msg=f"output slot {col}")
    np.testing.assert_allclose(rows_t[:, 1:8], rj[:, 1:8], atol=1e-3)
    assert (rj[:, 0] == de.CODE_TRACKING).all()
    assert rj[:, 12].sum() >= 1          # a keyframe is made in the window


def test_whole_drive(fixture):
    z = fixture
    eng = MageSlamTorchFused(port_settings("fast"),
                             fixture_calibration(z), seed=1, device="cpu")
    for i, img in enumerate(z["imgs"]):
        eng.process_frame(img, timestamp=i / 30.0)
    results = eng.flush()
    fossil = eng.fossilize()
    states = [results[i].state for i in range(len(z["imgs"]))]
    tracked = sum(s == TrackingState.TRACKING for s in states)
    assert TrackingState.TRACKING in states
    assert abs(tracked - int(z["fast_tracked"])) <= 2
    est, gt = [], []
    for i, s in enumerate(states):
        p = fossil.pose_for_frame(i)
        if s == TrackingState.TRACKING and p is not None:
            est.append(p)
            gt.append(z["gt_poses"][i])
    ate, _, _ = ate_rmse(np.asarray(est), np.asarray(gt))
    assert ate <= float(z["fast_ate_bound"]), (ate, float(z["fast_ate"]))
    assert np.isfinite(fossil.poses).all()


def test_state_round_trip(fixture):
    """convert.py carries every JAX EngineState leaf across and back with
    the same bits, and its per-container helpers agree with it."""
    ns = jax_state_namespace(fixture)
    st = convert.engine_state_from_jax(ns)
    back = convert.to_numpy(st)

    def walk(node, got, path):
        for name, val in vars(node).items():
            if isinstance(val, types.SimpleNamespace):
                walk(val, got[name], f"{path}{name}/")
            else:
                np.testing.assert_array_equal(got[name], val,
                                              err_msg=path + name)
                assert got[name].dtype == val.dtype, path + name

    walk(ns, back, "")
    for fn, field in ((convert.history_from_jax, "history"),
                      (convert.vocabulary_from_jax, "vocab"),
                      (convert.window_from_jax, "ba_window"),
                      (convert.map_from_jax, "map")):
        walk(getattr(ns, field), convert.to_numpy(fn(getattr(ns, field))),
             field + "/")


@pytest.mark.parametrize("change", [
    ("fuser", "use_fuser", True),
    ("parallel", "use_trajectory_sharding", True),
    ("parallel", "use_distributed_global_ba", True),
    ("stereo", "use_stereo_init", True),
])
def test_unsupported_settings_raise(change, fixture):
    """The four settings that used to raise (the fuser, stereo init and
    the parallel layer's two) now build and run a frame (the name and ids
    are kept so that the test's history stays in one place)."""
    bag, field, value = change
    s = port_settings("fast")
    s = s.replace(**{bag: dataclasses.replace(getattr(s, bag),
                                              **{field: value})})
    eng = MageSlamTorchFused(s, fixture_calibration(fixture), device="cpu")
    # the result resolves through the fetch ring, after the call
    assert eng.process_frame(fixture["imgs"][0], timestamp=0.0).state \
        == TrackingState.SKIPPED
    assert eng.result_for(0).state == TrackingState.INITIALIZING
    assert eng.output_row(0)[13] > 100


def test_multilevel_raises(fixture):
    """Two pyramid levels used to raise; they now build and run a frame
    whose features come from both levels (name kept)."""
    s = port_settings("fast")
    cam = s.mono.camera
    cam = dataclasses.replace(cam, features=dataclasses.replace(
        cam.features, num_levels=2))
    s = s.replace(mono=dataclasses.replace(s.mono, camera=cam))
    eng = MageSlamTorchFused(s, fixture_calibration(fixture), device="cpu")
    eng.process_frame(fixture["imgs"][0])
    assert eng.result_for(0).state == TrackingState.INITIALIZING
    octave = eng.state.init_feats.octave[0]
    valid = eng.state.init_feats.valid[0]
    assert int((valid & (octave == 0)).sum()) > 50
    assert int((valid & (octave == 1)).sum()) > 10


def test_relocalization_branch_raises(fixture):
    """The lost branch used to raise ``NotImplementedError``; it now runs a
    relocalization (the name is kept so that the test's history stays in
    one place).  A blank frame has nothing to match: the attempt is
    counted, fails, and the frame is reported as relocalizing; the map is
    only three keyframes old, so the engine starts over (the infant-map
    reset)."""
    z = fixture
    st = convert.engine_state_from_jax(jax_state_namespace(z))
    thr = port_settings("fast").track_local_map \
        .tracking_lost_count_until_reloc
    st = st._replace(bow_trained=torch.tensor(True),
                     lost_count=torch.tensor(thr - 1, dtype=torch.int32))
    eng = de.DeviceEngine(port_settings("fast"), fixture_calibration(z),
                          device="cpu")
    blank = torch.zeros((180, 320), dtype=torch.uint8)   # nothing to track
    st2, out = eng.step(st, blank, 1.0, 30)
    assert int(out[0]) == de.CODE_RELOCALIZING
    assert eng.counts["reloc_tried"] == 1
    assert eng.counts["reloc_accepted"] == 0
    assert int(st.map.kf_valid.sum()) <= 3 and bool(st.initialized)
    assert not bool(st2.initialized) and int(st2.map.kf_valid.sum()) == 0


@pytest.mark.parametrize("build", [
    lambda s, cal: MageSlamTorchFused(s, cal),
    lambda s, cal: MageSlamTorch(s, cal),
    lambda s, cal: de.DeviceEngine(s, cal),
    lambda s, cal: de.empty_state(s),
    lambda s, cal: volume_of_interest.compute_volume_of_interest(
        np.tile([1.0, 0, 0, 0, 0, 0, 0], (2, 1)), np.ones(2), np.full(2, 3.0),
        np.ones(2, bool)),
], ids=["MageSlamTorchFused", "MageSlamTorch", "DeviceEngine", "empty_state",
        "compute_volume_of_interest"])
def test_entry_points_default_to_the_card(build, fixture, monkeypatch):
    """With no ``device`` argument the entry points ask for the CUDA card;
    where there is none they raise and name ``device="cpu"`` instead of
    stepping down to the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build(port_settings("fast"), fixture_calibration(fixture))
