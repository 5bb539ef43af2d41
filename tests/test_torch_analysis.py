"""The analysis consumers of the port against the JAX package's.

Recordings (``io/recording.py``), xray captures and dataflow fingerprints
(``utils/xray.py``), value hashes (``utils/determinism.py``), the skeleton
key (``runtime/skeleton_key.py``), point-cloud denoising
(``mapstore/denoising.py``) and the tracing copies (``utils/tracing.py``).
Inputs are made from a seed with numpy, or taken from the carried map of
``tests/data/torch_orbit60.npz`` (``tools/make_torch_fixture.py``).

Tolerances: recordings, JSON captures, fingerprints, hashes, k-nearest
neighbour indices and the skeleton key's integer getters exactly; map
points, poses and trajectories 1e-6 (the same float32 values through the
same arithmetic, the trajectory through ``world_poses``); normals 1e-4 and
repositioned points 1e-5 on points in general position (the 3x3
eigendecompositions of two LAPACK builds agree to a few ulp where the
smallest eigenvalue is well separated).
"""

import json
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mageslam_tpu.fuser.samples import SensorSample as JSensorSample
from mageslam_tpu.io import recording as jrec
from mageslam_tpu.mapstore import denoising as jden
from mageslam_tpu.mapstore.map_state import MapState as JMapState
from mageslam_tpu.mapstore.pose_history import PoseHistory as JPoseHistory
from mageslam_tpu.runtime import skeleton_key as jsk
from mageslam_tpu.utils import determinism as jdet
from mageslam_tpu.utils import xray as jxray
from mageslam_tpu_torch import convert
from mageslam_tpu_torch.fuser.samples import SensorSample
from mageslam_tpu_torch.io import recording
from mageslam_tpu_torch.mapstore import denoising
from mageslam_tpu_torch.mapstore.map_state import MapState
from mageslam_tpu_torch.runtime import skeleton_key
from mageslam_tpu_torch.runtime.fossilized import FossilizedMap
from mageslam_tpu_torch.utils import determinism, xray
from mageslam_tpu_torch.utils.tracing import (Profiler, SkeletonLogger,
                                              SkeletonLoggerLevel)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_torch_fixture import OUT as ORBIT  # noqa: E402

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# recordings

def _write(mod, sample_cls, path, imgs, imu):
    with mod.RecordingWriter(path, {"session": "t", "n": len(imgs)}) as w:
        w.add_frame_stream(*imgs[0].shape)
        w.add_imu_stream()
        w.add_stream("poses", "custom", np.float32, (7,), version=2)
        for i, img in enumerate(imgs):
            w.append("frames", i / 30.0, img)
            w.append("poses", i / 30.0 + 1e-4,
                     np.arange(7, dtype=np.float32) * i)
        for s in imu:
            w.append_imu(s.timestamp, int(s.sample_type), s.data)
    return path


def _session(n=6, seed=3):
    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, 255, (12, 16), dtype=np.uint8)
            for _ in range(n)]
    imu = [(0.005 * k, k % 2, tuple(rng.normal(0, 1, 3)))
           for k in range(40)]
    return imgs, imu


def _events(rec):
    return [(t, name, np.array(r)) for t, name, r in rec.replay()]


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_recordings_cross_between_packages(writer, tmp_path):
    """A recording written by one package is the other's byte for byte
    (the manifest's creation time aside) and replays there in the same
    order with the same records."""
    imgs, imu = _session()
    paths = {}
    for name, mod, cls in (("torch", recording, SensorSample),
                           ("jax", jrec, JSensorSample)):
        samples = [cls.accel(t, d) if k == 0 else cls.gyro(t, d)
                   for t, k, d in imu]
        paths[name] = _write(mod, cls, tmp_path / name, imgs, samples)
    for stream in ("frames", "imu", "poses"):
        assert (paths["torch"] / f"{stream}.bin").read_bytes() == \
            (paths["jax"] / f"{stream}.bin").read_bytes()
    mans = [json.loads((paths[k] / "manifest.json").read_text())
            for k in ("torch", "jax")]
    for m in mans:
        m.pop("created")
    assert mans[0] == mans[1]

    reader = jrec.Recording if writer == "torch" else recording.Recording
    own = (recording.Recording if writer == "torch"
           else jrec.Recording)(paths[writer])
    other = reader(paths[writer])
    assert other.metadata == own.metadata == {"session": "t", "n": 6}
    a, b = _events(own), _events(other)
    assert [(t, n) for t, n, _ in a] == [(t, n) for t, n, _ in b]
    for (_, _, x), (_, _, y) in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    back = [f for _, f in other.frames()]
    for x, y in zip(imgs, back):
        np.testing.assert_array_equal(x, y)
    assert other.streams["poses"].version == 2


def test_record_session_matches_jax(tmp_path):
    imgs, imu = _session(4, seed=5)
    rgb = [np.stack([im] * 3, -1) for im in imgs]   # averaged to gray
    ts = np.arange(4) / 30.0
    recording.record_session(
        tmp_path / "t", rgb, ts,
        imu_samples=[SensorSample.gyro(t, d) for t, _, d in imu])
    jrec.record_session(
        tmp_path / "j", rgb, ts,
        imu_samples=[JSensorSample.gyro(t, d) for t, _, d in imu])
    for stream in ("frames", "imu"):
        assert (tmp_path / "t" / f"{stream}.bin").read_bytes() == \
            (tmp_path / "j" / f"{stream}.bin").read_bytes()


def test_recording_guards(tmp_path):
    recording.record_session(tmp_path / "r", [np.zeros((2, 2), np.uint8)],
                             [0.0])
    man = json.loads((tmp_path / "r" / "manifest.json").read_text())
    man["version"] = 99
    (tmp_path / "r" / "manifest.json").write_text(json.dumps(man))
    with pytest.raises(ValueError, match="newer"):
        recording.Recording(tmp_path / "r")
    with recording.RecordingWriter(tmp_path / "s") as w:
        w.add_frame_stream(4, 4)
        with pytest.raises(ValueError, match="shape"):
            w.append("frames", 0.0, np.zeros((5, 4), np.uint8))
        with pytest.raises(ValueError, match="duplicate"):
            w.add_frame_stream(4, 4)


# ---------------------------------------------------------------------------
# value hashes, xray and dataflow

def _values(seed=7):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(5, 7)).astype(np.float32),
            rng.integers(-3, 9, size=(11,)).astype(np.int32),
            rng.random(6) > 0.5, np.float32(2.5), 3, 0.25]


def _as(kind, v):
    if not isinstance(v, np.ndarray) and not isinstance(v, np.generic):
        return v
    return torch.as_tensor(np.asarray(v)) if kind == "torch" \
        else jnp.asarray(v)


def test_value_hash_of_tensors_matches_jax():
    vals = _values()
    want = jdet.value_hash(*[_as("jax", v) for v in vals])
    assert determinism.value_hash(*[_as("torch", v) for v in vals]) == want
    assert determinism.value_hash(*vals) == want
    # a tensor that needs grad, a non-contiguous view
    t = torch.as_tensor(vals[0]).requires_grad_()
    assert determinism.value_hash(t) == jdet.value_hash(vals[0])
    tv = torch.as_tensor(vals[0]).T
    assert determinism.value_hash(tv) == jdet.value_hash(vals[0].T)
    # the dtype stays: int32 and int64 of equal values hash apart
    assert determinism.value_hash(torch.arange(4, dtype=torch.int32)) != \
        determinism.value_hash(torch.arange(4, dtype=torch.int64))


@pytest.mark.cuda
def test_value_hash_of_card_tensors():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    vals = _values()
    on_card = [_as("torch", v).cuda() if isinstance(v, np.ndarray) else v
               for v in vals]
    assert determinism.value_hash(*on_card) == jdet.value_hash(*vals)


def _capture(mod, kind, max_elems):
    vals = _values()
    x = mod.Xray(max_elems=max_elems)
    x.capture("stage", {"a": _as(kind, vals[0]), "n": vals[4],
                        "t": (_as(kind, vals[1]), vals[5])},
              [_as(kind, vals[2]), _as(kind, vals[3])])

    @x.wrap("add")
    def add(a, b):
        return a + b
    add(_as(kind, vals[0]), b=_as(kind, vals[0]))
    return x


@pytest.mark.parametrize("max_elems", [4096, 8])
def test_xray_json_matches_jax(max_elems, tmp_path):
    xt = _capture(xray, "torch", max_elems)
    xj = _capture(jxray, "jax", max_elems)
    assert json.dumps(xt.records) == json.dumps(xj.records)
    xt.save(tmp_path / "t.json")
    xj.save(tmp_path / "j.json")
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    xt.reset()
    assert xt.records == []


def test_xray_of_a_map_state_matches_jax():
    """A NamedTuple state (the carried map) is written as its tuple."""
    z = np.load(ORBIT)
    leaves = {f: z[f"fast_state/map/{f}"] for f in JMapState._fields}
    mt = MapState(**{f: torch.as_tensor(v.astype(np.int32)
                                        if v.dtype == np.uint32 else v)
                     for f, v in leaves.items()})
    mj = JMapState(**{f: jnp.asarray(v) for f, v in leaves.items()})
    xt, xj = xray.Xray(max_elems=64), jxray.Xray(max_elems=64)
    xt.capture("map", mt, mt.num_kf_ever)
    xj.capture("map", mj, mj.num_kf_ever)
    rt, rj = xt.records[0], xj.records[0]
    for a, b, f in zip(rt["inputs"]["tuple"], rj["inputs"]["tuple"],
                       JMapState._fields):
        if f in ("kf_desc", "mp_desc"):   # int32 here, uint32 in JAX
            assert a["crc32"] == b["crc32"] and a["shape"] == b["shape"]
            continue
        assert a == b, f
    assert rt["outputs"] == rj["outputs"]


def test_dataflow_fingerprints_match_jax(tmp_path):
    vals = _values(11)
    logs = {}
    for name, mod in (("torch", xray), ("jax", jxray)):
        log = mod.DataFlowLog()
        for i in range(4):
            flow = mod.DataFlow(f"s{i}").input(_as(name, vals[0]) * i, i)
            flow.output(_as(name, vals[1]) + (i if i < 2 else 2 * i))
            log.add(flow)
        logs[name] = log
    assert logs["torch"].entries == logs["jax"].entries
    logs["torch"].save(tmp_path / "t.json")
    back = jxray.DataFlowLog.load(tmp_path / "t.json")
    assert back.first_divergence(logs["jax"]) is None
    # a change at stage 2 is found at 2 across the packages
    other = xray.DataFlowLog()
    for i in range(4):
        other.add(xray.DataFlow(f"s{i}").input(
            torch.as_tensor(vals[0]) * i, i).output(
            torch.as_tensor(vals[1]) + i))
    assert other.first_divergence(logs["jax"]) == 2
    assert logs["jax"].first_divergence(other) == 2


# ---------------------------------------------------------------------------
# skeleton key

@pytest.fixture(scope="module")
def carried():
    """The orbit's carried map and history (``fast_state40``) as a port
    and a JAX engine stand-in holding ``map_state`` and ``_history``."""
    z = np.load(ORBIT)
    mj = JMapState(**{f: jnp.asarray(z[f"fast_state40/map/{f}"])
                      for f in JMapState._fields})
    hj = JPoseHistory(**{f: jnp.asarray(z[f"fast_state40/history/{f}"])
                         for f in JPoseHistory._fields})
    mt, ht = convert.map_from_jax(mj), convert.history_from_jax(hj)
    return (types.SimpleNamespace(map_state=mt, _history=ht),
            types.SimpleNamespace(map_state=mj, _history=hj))


def test_skeleton_key_getters_match_jax(carried):
    port, ref = carried
    kt, kj = skeleton_key.craft_skeleton_key(port), \
        jsk.craft_skeleton_key(ref)
    assert kj.get_map_points().shape[0] > 100
    np.testing.assert_allclose(kt.get_map_points(), kj.get_map_points(),
                               atol=1e-6)
    np.testing.assert_allclose(kt.get_keyframe_poses(),
                               kj.get_keyframe_poses(), atol=1e-6)
    np.testing.assert_array_equal(kt.get_keyframe_frame_ids(),
                                  kj.get_keyframe_frame_ids())
    np.testing.assert_array_equal(kt.get_covisibility(),
                                  kj.get_covisibility())
    tt, tj = kt.get_spanning_tree(), kj.get_spanning_tree()
    assert isinstance(tt.parent, np.ndarray)
    np.testing.assert_array_equal(tt.parent, np.asarray(tj.parent))
    np.testing.assert_array_equal(tt.root, np.asarray(tj.root))
    np.testing.assert_allclose(tt.parent_weight,
                               np.asarray(tj.parent_weight), atol=1e-6)
    (ft, pt), (fj, pj) = kt.get_trajectory(), kj.get_trajectory()
    assert len(ft) > 30
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(pt, pj, atol=1e-5)
    seen = []

    class Sink(skeleton_key.Introspector):
        def on_map_snapshot(self, snap):
            seen.append(snap["num_keyframes"])
    kt.introspection.register(Sink())
    snap = kt.snapshot()
    assert seen == [snap["num_keyframes"]] == [len(kj.get_keyframe_poses())]
    assert snap["num_map_points"] == len(kj.get_map_points())
    assert kt.get_fuser() is None


def test_skeleton_key_and_fossil_serve_both_engines(carried):
    """The host engine keeps ``_history``, the fused facade its engine
    state: the key's trajectory and ``FossilizedMap.from_engine`` read
    either."""
    from mageslam_tpu_torch.runtime.fused import MageSlamTorchFused
    from mageslam_tpu_torch.runtime.slam import MageSlamTorch
    from make_torch_fixture import fixture_settings

    port, _ = carried
    z = np.load(ORBIT)
    from test_torch_engine import fixture_calibration
    s = convert.settings_from_jax(fixture_settings("fast"))
    cal = fixture_calibration(z)
    host = MageSlamTorch(s, cal, device="cpu")
    host._map, host._history = port.map_state, port._history
    fused = MageSlamTorchFused(s, cal, device="cpu")
    fused.state = fused.state._replace(map=port.map_state,
                                       history=port._history)
    want = skeleton_key.SkeletonKey(port).get_trajectory()
    for eng in (host, fused):
        fids, poses = skeleton_key.SkeletonKey(eng).get_trajectory()
        np.testing.assert_array_equal(fids, want[0])
        np.testing.assert_array_equal(poses, want[1])
        fossil = FossilizedMap.from_engine(eng)
        np.testing.assert_array_equal(np.sort(fids), fossil.frame_ids)


# ---------------------------------------------------------------------------
# denoising

def _cloud(n, seed):
    """Points on a gently curved surface with noise (general position),
    seen from a camera above it."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1, 1, (n, 2))
    z = 0.15 * np.sin(2 * xy[:, 0]) + 0.1 * xy[:, 1] ** 2 \
        + rng.normal(0, 0.01, n)
    pts = np.concatenate([xy, z[:, None]], -1).astype(np.float32)
    cam = np.array([0.2, -0.1, 2.5])
    view = pts - cam
    view = (view / np.linalg.norm(view, axis=-1, keepdims=True)) \
        .astype(np.float32)
    valid = rng.random(n) > 0.1
    return pts, view, valid


@pytest.mark.parametrize("n,k", [(300, 12), (257, 8)])
def test_denoising_matches_jax(n, k):
    pts, view, valid = _cloud(n, n)
    P, V, M = (torch.as_tensor(x) for x in (pts, view, valid))
    Pj, Vj, Mj = (jnp.asarray(x) for x in (pts, view, valid))
    np.testing.assert_array_equal(
        denoising.knn_indices(P, M, k).numpy(),
        np.asarray(jden.knn_indices(Pj, Mj, k)))
    nt = denoising.estimate_normals(P, M, V, k)
    nj = jden.estimate_normals(Pj, Mj, Vj, k)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), atol=1e-4)
    # on the valid points the field is what a consumer reads: the normals
    # face the camera and the surface's up direction dominates
    assert (np.sum(nt.numpy()[valid] * view[valid], -1) <= 0).all()
    mt = denoising.mollify_normals(P, nt, M, k, sigma=0.2, iters=3)
    mj = jden.mollify_normals(Pj, nj, Mj, k, sigma=0.2, iters=3)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-4)
    rt = denoising.reposition_points(P, mt, M, k, sigma=0.3)
    rj = jden.reposition_points(Pj, mj, Mj, k, sigma=0.3)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-5)
    np.testing.assert_array_equal(rt.numpy()[~valid], pts[~valid])


def test_denoising_flattens_a_plane(rng):
    """``tests/test_aux.py``'s plane case on the port."""
    n = 200
    pts = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                    rng.normal(0, 0.02, n)], -1).astype(np.float32)
    view = torch.as_tensor(np.tile(np.array([0, 0, 1.0], np.float32),
                                   (n, 1)))
    P, valid = torch.as_tensor(pts), torch.ones(n, dtype=torch.bool)
    normals = denoising.estimate_normals(P, valid, view)
    assert np.median(np.abs(normals.numpy()[:, 2])) > 0.95
    normals = denoising.mollify_normals(P, normals, valid)
    moved = denoising.reposition_points(P, normals, valid, sigma=0.3)
    assert float(moved[:, 2].std()) < np.std(pts[:, 2])


# ---------------------------------------------------------------------------
# tracing

def test_profiler_scopes():
    p = Profiler()
    for _ in range(2):
        with p.scope("a"):
            pass
    with pytest.raises(KeyError):
        with p.scope("b", frame=7):
            with p.scope("c"):
                raise KeyError("inside")      # the scopes still close
    assert p.stats["a"].count == 2 and p.stats["b"].count == 1
    report = p.report()
    assert "a" in report and "b" in report
    spans = p.take_spans()
    assert [(s.name, s.parent, s.frame) for s in spans] == [
        ("a", -1, -1), ("a", -1, -1), ("b", -1, 7), ("c", 2, 7)]
    assert all(s.start_ns <= s.end_ns for s in spans)
    assert spans[2].start_ns <= spans[3].start_ns \
        and spans[3].end_ns <= spans[2].end_ns
    assert p.take_spans() == []
    off = Profiler(enabled=False)
    with off.scope("a"):
        pass
    assert dict(off.stats) == {} and off.take_spans() == []


def test_object_trace_and_skeleton_logger():
    """The skeleton logger's levels (the port keeps no ObjectTrace: no
    code of it fired one)."""
    log = SkeletonLogger(level=SkeletonLoggerLevel.TRACKING
                         | SkeletonLoggerLevel.IMAGE)
    log.log(SkeletonLoggerLevel.TRACKING, "t")
    log.log(SkeletonLoggerLevel.MAPPING, "m")
    log.log(SkeletonLoggerLevel.IMAGE, "i", data=np.zeros(2))
    assert [r[2] for r in log.records] == ["t", "i"]
    assert [r[2] for r in log.for_level(SkeletonLoggerLevel.IMAGE)] == ["i"]
