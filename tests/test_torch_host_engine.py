"""The host-orchestrated engine, ``MageSlamTorch`` (``runtime/slam.py``),
against the JAX package's ``MageSlamTPU``.

Goldens come from ``tests/data/torch_host.npz``
(``tools/make_torch_host_fixture.py``): the JAX host engine's carried
state before and after one frame of each kind of step (initialization,
third-frame confirmation and rejection, tracking, idle polish, a keyframe's
mapping pass, fossilize on the console's ``mini_seq`` drive; a failed
relocalization and a loop attempt that runs a detection on the blackout
drive), its determinator streams, and whole drives.  No JAX engine runs
here.

Randomness: the port's engine draws through ``sampler_factory()`` at the
four points where the JAX engine splits its key; ``JaxChain`` replays that
key chain from the carried key, and ``JaxDraws`` draws each attempt's
minimal sets as the JAX function does from its subkey.

Tolerances: integers and booleans (result codes, keyframe and point
validity, associations, history anchors, counts, the host scalars, the
keyframe decision) exactly; poses 1.2e-4 (float32 LM steps summed in
another order; the keyframe step, with two local-BA windows, leaves them
3e-5 apart); points and their distances 1.2e-4 plus 5e-4 of their own
size (the same step leaves the far, weakly constrained points of the
console map, at 50-160 baselines, 2.3e-4 of their distance apart); the
persisted lambda to 1e-3 relative.

The initialization's 5-point pool depends on the LAPACK build, so its step
is held as ``test_torch_init_track_map.py`` holds it: with the JAX
attempt's essential result injected, structure exactly, poses 2e-4 and the
new points' bearings 1e-4, their depths 1e-2 relative (the pair's points
lie 26 to 128 baselines away, where a two-view BA's depth is 100 times
less determined than its bearing: measured 1.6e-4, 1.3e-5 and 4.8e-3);
on its own, by outcome.
"""

import dataclasses
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mageslam_tpu.tracking import keyframe_decision as jkd
from mageslam_tpu_torch import convert
from mageslam_tpu_torch.bow import database as bdb
from mageslam_tpu_torch.bow import vocab as bv
from mageslam_tpu_torch.config import MageSlamSettings
from mageslam_tpu_torch.io.datasets import load_dataset
from mageslam_tpu_torch.io.native_loader import read_image_gray
from mageslam_tpu_torch.mapping import global_ba
from mageslam_tpu_torch.mapstore.map_state import MapState
from mageslam_tpu_torch.mapstore.pose_history import PoseHistory
from mageslam_tpu_torch.parallel.distributed_ba import make_mesh
from mageslam_tpu_torch.runtime.results import TrackingState
from mageslam_tpu_torch.runtime.slam import MageSlamTorch
from mageslam_tpu_torch.tracking import keyframe_decision as kd
from mageslam_tpu_torch.tracking.frontend import FrameFeatures
from mageslam_tpu_torch.utils.determinism import Determinator, value_hash

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_torch_host_fixture import (CHANGED_ROWS, CODES, MINI_SEQ,  # noqa
                                     OUT)
from make_torch_ring_fixture import OUT as RING  # noqa: E402
from test_torch_reloc import JaxKeySampler, ring_calibration  # noqa: E402

torch.set_num_threads(2)
ATOL = 1.2e-4
POINT_RTOL = 5e-4
INIT_ATOL, INIT_DEPTH_RTOL = 2e-4, 1e-2
STATE_OF = {v: k for k, v in CODES.items()}


@pytest.fixture(scope="module")
def z():
    return np.load(OUT)


@pytest.fixture(scope="module")
def ring():
    return np.load(RING)


# ---------------------------------------------------------------------------
# the JAX key chain

class JaxDraws:
    """``sampler(p, num, k)`` of one attempt, drawing as the JAX function
    that took ``key`` does.  The first call says which attempt it is:
    initialization (1024 8-point sets from ``kE``, 512 5-point sets from
    ``fold_in(kE, 5)``, 512 4-point sets from ``kH``, where
    ``kE, kH = split(key)``); vocabulary training (``sampler(p, 1, 6)``:
    level-1 seeds from ``k1``, then each cluster's from ``split(k2, 6)``,
    where ``k1, k2 = split(key)``); relocalization or loop detection (a
    2-D ``p``: ``JaxKeySampler``)."""

    def __init__(self, key):
        self.key = key
        self.calls = 0
        self.reloc = None

    @staticmethod
    def _vmapped(key, p, num, k):
        n = p.shape[0]
        return np.asarray(jax.vmap(lambda kk: jax.random.choice(
            kk, n, shape=(k,), replace=False, p=p))(
                jax.random.split(key, num)))

    def __call__(self, p, num, k):
        if p.ndim == 2 or self.reloc is not None:
            self.reloc = self.reloc or JaxKeySampler(self.key)
            return self.reloc(p, num, k)
        pj = jnp.asarray(np.asarray(p.cpu()))
        c, self.calls = self.calls, self.calls + 1
        if (num, k) == (1, 6):          # vocabulary training
            k1, k2 = jax.random.split(self.key)
            kk = k1 if c == 0 else jax.random.split(k2, 6)[c - 1]
            idx = np.asarray(jax.random.choice(kk, pj.shape[0], shape=(k,),
                                               replace=False, p=pj))[None]
        else:                           # initialization
            kE, kH = jax.random.split(self.key)
            kk = {8: kE, 5: jax.random.fold_in(kE, 5), 4: kH}[k]
            idx = self._vmapped(kk, pj, num, k)
        return torch.as_tensor(np.array(idx), device=p.device).long()


class JaxChain:
    """``sampler_factory`` on the JAX engine's chain: each call splits the
    carried key and draws the attempt from the subkey."""

    def __init__(self, key_data):
        self.key = jax.random.wrap_key_data(jnp.asarray(key_data))
        self.calls = 0

    def __call__(self):
        self.key, sub = jax.random.split(self.key)
        self.calls += 1
        return JaxDraws(sub)

    def key_data(self):
        return np.asarray(jax.random.key_data(self.key))


# ---------------------------------------------------------------------------
# carried states

def _tree(z, prefix: str) -> dict:
    return {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}


def _ns(d: dict, group: str):
    return types.SimpleNamespace(**{k[len(group) + 1:]: v for k, v in
                                    d.items() if k.startswith(group + "/")
                                    and "/" not in k[len(group) + 1:]})


def _t(x):
    return convert.tensor_from_numpy(x)


def load_state(eng: MageSlamTorch, st: dict) -> None:
    """Put a carried JAX host state into a port engine."""
    eng._map = convert.from_jax(MapState, _ns(st, "map"))
    eng._history = convert.from_jax(PoseHistory, _ns(st, "history"))
    eng._bow = bdb.BowDatabase(
        convert.from_jax(bv.Vocabulary, _ns(st, "bow/vocab")),
        _t(st["bow/kf_sig"]), _t(st["bow/kf_valid"]))
    for k, v in st.items():
        if k.startswith("scalar/"):
            setattr(eng, "_" + k[7:], v.item())
    for name in ("pose_prev", "pose_prev2"):
        p = st[f"pose/{name}"]
        setattr(eng, "_" + name, None if np.isnan(p).any() else _t(p))
    eng._kf_frame_ids = [int(f) for f in st["kf_frame_ids"]]
    eng._init_buffer = [
        (int(f), float(t), FrameFeatures(*[
            _t(st[f"init/feats/{name}"][j])
            for name in FrameFeatures._fields]))
        for j, (f, t) in enumerate(zip(st["init/fid"], st["init/ts"]))]
    eng._bow_training = [(_t(d), _t(v)) for d, v in zip(
        st.get("train/desc", []), st.get("train/valid", []))]


def port_state(eng: MageSlamTorch) -> dict:
    out = {}
    for group, tup in (("map", eng._map), ("history", eng._history),
                       ("bow/vocab", eng._bow.vocab)):
        for f in tup._fields:
            out[f"{group}/{f}"] = getattr(tup, f).numpy()
    out["bow/kf_sig"] = eng._bow.kf_sig.numpy()
    out["bow/kf_valid"] = eng._bow.kf_valid.numpy()
    return out


FLOATS = {"map/kf_pose", "map/mp_pos", "map/mp_normal", "map/mp_max_dist",
          "history/rel_pose", "history/anchor_c", "bow/kf_sig",
          "map/kf_uv", "map/kf_xn"}


def assert_state_matches(eng: MageSlamTorch, want: dict, before: dict,
                         chain: JaxChain, skip=(), atol: float = ATOL):
    got = port_state(eng)
    for k, v in want.items():
        if k in skip or k.startswith(("pose/", "kf_frame_ids")):
            continue
        base = k.rsplit("/", 1)[0]
        if base in CHANGED_ROWS:
            if k.endswith("/idx"):
                idx = want[k]
                g = got[base].reshape(len(got[base]), -1)
                b = before[base].reshape(len(before[base]), -1)
                if got[base].dtype == np.int32 and b.dtype == np.uint32:
                    b = b.view(np.int32)
                changed = np.nonzero((g != b).any(-1))[0]
                np.testing.assert_array_equal(changed, idx, err_msg=k)
                rows = want[base + "/rows"]
                if base in FLOATS:
                    np.testing.assert_allclose(got[base][idx], rows,
                                               atol=atol, err_msg=base)
                else:
                    np.testing.assert_array_equal(
                        got[base][idx].view(rows.dtype)
                        if rows.dtype == np.uint32 else got[base][idx],
                        rows, err_msg=base)
            continue
        if k.startswith("scalar/"):
            g = getattr(eng, "_" + k[7:])
            if k in ("scalar/lam",):
                np.testing.assert_allclose(g, v.item(), rtol=1e-3,
                                           err_msg=k)
            else:
                assert g == v.item(), (k, g, v)
            continue
        if k == "key_data":
            np.testing.assert_array_equal(chain.key_data(), v)
            continue
        g = got[k]
        if g.dtype == np.int32 and v.dtype == np.uint32:
            g = g.view(np.uint32)
        if k in ("map/mp_pos", "map/mp_normal", "map/mp_max_dist"):
            ok = want["map/mp_valid"]
            np.testing.assert_allclose(g[ok], v[ok], atol=atol,
                                       rtol=POINT_RTOL, err_msg=k)
        elif k in FLOATS or v.dtype.kind == "f":
            np.testing.assert_allclose(g, v, atol=atol, rtol=1e-4,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, v, err_msg=k)
    for name in ("pose_prev", "pose_prev2"):
        p, g = want[f"pose/{name}"], getattr(eng, "_" + name)
        if np.isnan(p).any():
            assert g is None
        else:
            np.testing.assert_allclose(g.numpy(), p, atol=atol)
    assert eng._kf_frame_ids == [int(f) for f in want["kf_frame_ids"]]


def _drive_inputs(z, ring, event: str):
    """(settings, calibration, frame image, timestamp) of an event."""
    i = int(z[f"ev_{event}_frame"])
    if str(z[f"ev_{event}_drive"]) == "console":
        s = MageSlamSettings.from_json(str(z["con_settings_json"]))
        seq = load_dataset(str(MINI_SEQ))
        cal = seq.tracking_calibration(320)
        img = read_image_gray(seq.image_paths[i], 320, cal.height) \
            if i >= 0 else None
        ts = float(seq.timestamps[i] - seq.timestamps[0]) if i >= 0 \
            else None
        return s, cal, img, ts
    s = MageSlamSettings.from_json(str(ring["ring_fast_settings_json"]))
    img = np.cumsum(ring["imgs_dy"][i], axis=0, dtype=np.uint8)
    return s, ring_calibration(ring), img, float(ring["timestamps"][i])


def _step(z, ring, event: str, determinator=None):
    s, cal, img, ts = _drive_inputs(z, ring, event)
    before = _tree(z, f"ev_{event}/before/")
    chain = JaxChain(before["key_data"])
    eng = MageSlamTorch(s, cal, device="cpu", sampler_factory=chain,
                        determinator=determinator)
    load_state(eng, before)
    r = eng.process_frame(img, ts) if img is not None else eng.fossilize()
    return eng, r, before, _tree(z, f"ev_{event}/after/"), chain


# ---------------------------------------------------------------------------
# step parity from carried states

@pytest.mark.parametrize("event", ["confirm", "reject", "track", "polish",
                                   "keyframe", "reloc", "loop"])
def test_step_from_carried_state(event, z, ring):
    eng, r, before, want, chain = _step(z, ring, event)
    code = int(z[f"ev_{event}_result_code"])
    assert r.state == TrackingState(STATE_OF[code])
    jp = z[f"ev_{event}_result_pose"]
    if np.isnan(jp).any():
        assert r.pose is None
    else:
        np.testing.assert_allclose(r.pose, jp, atol=ATOL)
    assert_state_matches(eng, want, before, chain)


def test_initialization_step_given_the_essential_result(z, ring,
                                                       monkeypatch):
    """The initialization frame with the JAX attempt's essential RANSAC
    result injected (the 5-point pool's nullspace basis differs between
    LAPACK builds): everything after it, the homography RANSAC on JAX's
    draws, the triangulation, the init BA, the map seeding and the host
    scalars, as the JAX step left them."""
    from mageslam_tpu_torch.solvers import essential
    from mageslam_tpu_torch.tracking import initialization
    stored = _tree(z, "ev_init/essential/")
    carried = essential.EssentialResult(
        *(torch.as_tensor(stored[f]) for f in essential.EssentialResult
          ._fields))
    monkeypatch.setattr(initialization.essential,
                        "essential_ransac_from_samples",
                        lambda *a, **k: carried)
    eng, r, before, want, chain = _step(z, ring, "init")
    assert r.state == TrackingState.TRACKING
    np.testing.assert_allclose(r.pose, z["ev_init_result_pose"],
                               atol=INIT_ATOL)
    assert_state_matches(eng, want, before, chain, atol=INIT_ATOL,
                         skip=("map/mp_pos", "map/mp_max_dist"))
    ok = want["map/mp_valid"]
    got, ref = eng._map.mp_pos.numpy()[ok], want["map/mp_pos"][ok]
    dg, dr = (np.linalg.norm(x, axis=-1) for x in (got, ref))
    np.testing.assert_allclose(got / dg[:, None], ref / dr[:, None],
                               atol=1e-4)
    np.testing.assert_allclose(dg, dr, rtol=INIT_DEPTH_RTOL)
    np.testing.assert_allclose(eng._map.mp_max_dist.numpy()[ok],
                               want["map/mp_max_dist"][ok],
                               rtol=INIT_DEPTH_RTOL)
    assert eng._init_buffer == []


def test_initialization_step_on_jax_draws(z, ring):
    """The same frame with nothing injected: the attempt succeeds and
    seeds the same two keyframe slots; its essential winner may be another
    member of the consensus (on this pair 195 points against JAX's 223),
    so the map is not compared."""
    eng, r, before, want, chain = _step(z, ring, "init")
    assert r.state == TrackingState.TRACKING
    assert chain.calls == 1
    np.testing.assert_array_equal(chain.key_data(), want["key_data"])
    for f in ("kf_valid", "kf_frame_id", "kf_immortal", "num_kf_ever"):
        np.testing.assert_array_equal(getattr(eng._map, f).numpy(),
                                      want[f"map/{f}"])
    assert eng._init_probation and eng._initialized
    assert eng._init_buffer == []
    assert eng._kf_frame_ids == [int(f) for f in want["kf_frame_ids"]]


def test_fossilize_from_carried_state(z, ring):
    eng, fossil, before, want, chain = _step(z, ring, "fossilize")
    assert_state_matches(eng, want, before, chain)
    np.testing.assert_array_equal(fossil.frame_ids, z["con_fossil_ids"])
    np.testing.assert_allclose(fossil.poses, z["con_fossil_poses"],
                               atol=ATOL)


def test_loop_attempt_ran_a_detection(z, ring):
    """The blackout drive's loop event draws twice (the keyframe's loop
    attempt after its mapping pass); the carried key moves as JAX's."""
    eng, r, before, want, chain = _step(z, ring, "loop")
    assert chain.calls >= 1
    np.testing.assert_array_equal(chain.key_data(), want["key_data"])
    assert int(z["ev_loop_frame"]) in z["bo_detections"].tolist()


# ---------------------------------------------------------------------------
# the keyframe decision

def test_keyframe_decision_matches_jax(rng):
    from mageslam_tpu.config import KeyframeSettings as JKeyframeSettings
    sj = JKeyframeSettings(min_frame_count=3, min_frame_count_reloc=3,
                           min_tracking_point_count=15)
    st = convert.settings_from_jax(
        __import__("mageslam_tpu.config", fromlist=["MageSlamSettings"])
        .MageSlamSettings().replace(keyframe=sj)).keyframe
    n_yes = 0
    for _ in range(400):
        x = dict(frames_since_keyframe=int(rng.integers(0, 8)),
                 frames_since_reloc=int(rng.integers(0, 10)),
                 num_tracked_points=int(rng.integers(0, 320)),
                 ref_kf_point_count=int(rng.integers(0, 1500)),
                 num_matches=int(rng.integers(0, 320)),
                 mapping_idle=bool(rng.random() > 0.3),
                 motion_distance=float(rng.uniform(0, 0.3)),
                 min_scene_depth=float(rng.uniform(0.2, 3.0)),
                 densely_connected=bool(rng.random() > 0.5))
        want = jkd.should_add_keyframe(sj, jkd.KeyframeDecisionInputs(**x))
        assert kd.should_add_keyframe(st, kd.KeyframeDecisionInputs(**x)) \
            == want
        n_yes += want
    assert 20 < n_yes < 380


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_densely_connected_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        n = int(rng.integers(0, 300))
        uv = rng.uniform(-5, [330, 190], (n, 2)).astype(np.float32)
        tracked = rng.random(n) > rng.uniform(0, 1)
        args = (320, 180, int(rng.integers(1, 8)), int(rng.integers(1, 6)),
                int(rng.integers(1, 5)), float(rng.uniform(0, 0.6)))
        assert kd.densely_connected(uv, tracked, *args) == \
            jkd.densely_connected(uv, tracked, *args)


# ---------------------------------------------------------------------------
# determinism streams

class ValueDeterminator(Determinator):
    def __init__(self):
        super().__init__()
        self.values = {}

    def check(self, channel, *values):
        h = super().check(channel, *values)
        n = len(self._streams[channel]) - 1
        self.values[(channel, n)] = values
        return h


def test_determinator_stream_of_the_first_frames(z):
    """The console drive's first frames from scratch, on JAX's key chain:
    the same channels in the same order, and each checkpoint whose values
    equal JAX's hashes as JAX's did."""
    s = MageSlamSettings.from_json(str(z["con_settings_json"]))
    seq = load_dataset(str(MINI_SEQ))
    cal = seq.tracking_calibration(320)
    det = ValueDeterminator()
    eng = MageSlamTorch(s, cal, seed=1, device="cpu", determinator=det,
                        sampler_factory=JaxChain(np.asarray(
                            jax.random.key_data(jax.random.key(1)))))
    n = int(z["det_frames"])
    for i in range(n):
        eng.process_frame(read_image_gray(seq.image_paths[i], 320,
                                          cal.height),
                          float(seq.timestamps[i] - seq.timestamps[0]))
    equal = compared = 0
    for ch in z["det_channels"].tolist():
        want = [k for k in z.files if k.startswith(f"detf_{ch}_")]
        got = det.streams.get(ch, [])
        assert len(got) == len(want), ch
        for j in range(len(want)):
            fid, *vals = det.values[(ch, j)]
            assert fid == int(z[f"detf_{ch}_{j}"]), (ch, j)
            jvals = [z[f"detv_{ch}_{j}_{v}"] for v in range(len(vals))]
            same = all(np.array_equal(
                np.asarray(a).view(b.dtype) if np.asarray(a).dtype
                == np.int32 and b.dtype == np.uint32 else np.asarray(a), b)
                for a, b in zip([x.numpy() if torch.is_tensor(x) else x
                                 for x in vals], jvals))
            compared += 1
            if same:
                equal += 1
                assert got[j] == int(z[f"det_{ch}"][j]), (ch, j)
    assert compared >= n and equal >= 0.75 * compared, (equal, compared)


def test_value_hash_dtypes_as_jax(z):
    """The host engine hashes Python ints and floats and float32 / int32
    arrays, as JAX passes them."""
    assert value_hash(3, 0.5) == value_hash(np.int64(3), np.float64(0.5))
    assert value_hash(torch.ones(3, dtype=torch.int32)) == \
        value_hash(np.ones(3, np.uint32))


# ---------------------------------------------------------------------------
# the parallel layer's settings

@pytest.mark.parametrize("name", ["use_distributed_global_ba",
                                  "use_trajectory_sharding"])
def test_parallel_settings_raise(name, z, monkeypatch):
    """The parallel settings, which used to raise, now build the host
    engine and run a frame (name and ids kept so that the history stays in
    one place), with the default mesh made 8 CPU shards."""
    monkeypatch.setattr(global_ba, "default_mesh_for",
                        lambda m: make_mesh(devices=["cpu"] * 8))
    s = MageSlamSettings.from_json(str(z["con_settings_json"]))
    s = s.replace(parallel=dataclasses.replace(s.parallel, **{name: True}))
    seq = load_dataset(str(MINI_SEQ))
    cal = seq.tracking_calibration(320)
    eng = MageSlamTorch(s, cal, device="cpu")
    r = eng.process_frame(read_image_gray(seq.image_paths[0], 320,
                                          cal.height), 0.0)
    assert r.state == TrackingState.INITIALIZING


def test_fossilize_routes_through_the_parallel_layer(z, ring, monkeypatch):
    """With distributed global BA on and the default mesh made 8 CPU
    shards, the host engine's fossilize runs the distributed solver and
    lands where the JAX host engine's (single-device) fossilize does."""
    monkeypatch.setattr(global_ba, "default_mesh_for",
                        lambda m: make_mesh(devices=["cpu"] * 8))
    calls = []
    real = global_ba.global_bundle_adjust_distributed

    def wrapped(*a, **k):
        calls.append(a[3].size)
        return real(*a, **k)
    monkeypatch.setattr(global_ba, "global_bundle_adjust_distributed",
                        wrapped)
    s, cal, _, _ = _drive_inputs(z, ring, "fossilize")
    s = s.replace(parallel=dataclasses.replace(
        s.parallel, use_distributed_global_ba=True))
    before = _tree(z, "ev_fossilize/before/")
    eng = MageSlamTorch(s, cal, device="cpu",
                        sampler_factory=JaxChain(before["key_data"]))
    load_state(eng, before)
    fossil = eng.fossilize()
    assert calls and set(calls) == {8}
    np.testing.assert_array_equal(fossil.frame_ids, z["con_fossil_ids"])
    np.testing.assert_allclose(fossil.poses, z["con_fossil_poses"],
                               atol=ATOL)


# ---------------------------------------------------------------------------
# whole drive (slow)

@pytest.mark.slow
def test_host_console_drive_on_mini_seq(z, tmp_path):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "examples"))
    import console_torch
    res = console_torch.run(console_torch.parse_args(
        ["--cpu", "--host-engine", "--dataset", str(MINI_SEQ),
         "--csv", str(tmp_path / "f.csv")]))
    assert isinstance(res["engine"], MageSlamTorch)
    assert res["tracked"] >= int(z["con_tracked"].min()) - 3
    assert res["ate"] < float(z["con_ate_bound"])


# ---------------------------------------------------------------------------
# the stereo bootstrap and the facade queries

def test_stereo_bootstrap_and_queries():
    """``process_stereo_frames`` on ``torch_facade.npz``'s pair seeds the
    map of the JAX facade's bootstrap (both engines of both packages seed
    through ``facade_common``); then a pair is tracked on the primary
    camera, results resolve at once, and the trajectory, VOI and sensor
    queries answer."""
    from mageslam_tpu_torch.fuser.samples import SensorSample
    from mageslam_tpu_torch.geometry import se3
    from test_torch_stereo_facade import (FACADE, facade_settings,
                                          stereo_calibration)
    f = np.load(FACADE)
    pair = np.cumsum(f["st_pair_dy"], axis=1, dtype=np.uint8)
    mono = np.cumsum(f["st_mono_dy"], axis=1, dtype=np.uint8)
    extr = f["st_extrinsics"]
    eng = MageSlamTorch(facade_settings(f), stereo_calibration(f), seed=1,
                        device="cpu")
    r1, r2 = eng.process_stereo_frames(pair[0], pair[1], extr, timestamp=0.0)
    assert [r1.state.value, r2.state.value] == f["st_pair_states"].tolist()
    np.testing.assert_allclose(np.stack([r1.pose, r2.pose]),
                               f["st_pair_poses"], atol=1e-6)
    assert eng.num_keyframes == int(f["st_keyframes"]) == 2
    pts = eng.map_state.mp_pos[eng.map_state.mp_valid].numpy()
    assert abs(len(pts) - int(f["st_map_points"])) <= 2
    assert np.median(pts[:, 2]) == pytest.approx(
        float(f["st_median_depth"]), rel=1e-3)
    assert eng.add_sensor_sample(SensorSample.gyro(0.01, (0.0, 0.1, 0.0)))
    r1, r2 = eng.process_stereo_frames(mono[0], mono[0], extr,
                                       timestamp=float(f["st_ts"][0]))
    assert r1.frame_id == r2.frame_id == 1
    assert r1.state == r2.state == TrackingState.TRACKING
    want = se3.pose_compose(torch.as_tensor(extr),
                            torch.as_tensor(r1.pose)).numpy()
    np.testing.assert_allclose(r2.pose, want, atol=1e-6)
    got = eng.get_tracking_results_for_frames([0, 1, 5])
    assert [g.state for g in got] == [TrackingState.TRACKING] * 2 \
        + [TrackingState.SKIPPED]
    np.testing.assert_allclose(got[1].pose, r1.pose, atol=1e-5)
    voi = eng.try_get_volume_of_interest()
    assert voi is None or (voi.max_corner > voi.min_corner).all()
    assert eng.get_gravity_direction() is None
