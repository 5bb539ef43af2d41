"""The long session at keyframe capacity: the port against the JAX package.

Goldens come from ``tests/data/torch_long640.npz``
(``tools/make_torch_long_fixture.py``): ``tests/test_long_session.py``'s
640-frame slow double loop with 40 keyframe slots, driven by the JAX fused
engine on the CPU at seeds 1-3, where keyframe creation runs past
capacity (seed 1: 55 keyframes ever, 40 alive at the end).  The frames are
rendered here by the port's own ``io/synthetic.py`` and checked against the
stored CRC-32s.

- The carried capacity step: the JAX engine's state after the frame before
  the first step whose ``drain_pending`` meets a full map, one
  ``DeviceEngine.step`` (force cull, re-anchoring, insert into the freed
  slot, new points, the first local-BA chunk) against the JAX state after
  it; the same for the second force-cull step (the drive has no drain whose
  pending associations meet a recycled point slot: ``stale_kind``).
  Integer and boolean fields exactly, poses and points within 1e-3.
- The force cull in isolation on that map: ``cull_keyframes(window=K)``,
  ``nearest_valid_kf``, ``reanchor``, then ``insert_keyframe`` into the
  freed slot, ``anchor_frame_to_kf`` onto it and ``allocate_map_points``
  into freed point slots, each called live in both packages.
- The pose history's ring past its end: 80 frames into 32 slots with
  re-anchoring between them, live in both packages.
- ``fossilize``'s global BA and trajectory on the state after the capacity
  step, against the JAX package's.
- The host engine's capacity guard (``MageSlamTorch``, 9 keyframe slots,
  the ring's frames before its blackout) from the JAX host engine's state
  before its first firing, on the JAX engine's key chain: that frame, and
  the guard's exit when nothing is cullable; the drive through all 31
  firings is ``slow``.
- Drives from a stored initial map (frame 3), as ``chip_smoke.py``'s
  long-session phase drives them: the JAX engine's, and the port's own on
  the card, each against the JAX engine's drive from the same map, frames
  0-14 exactly and the whole 640 frames by outcome (``slow``, with a drive
  from the port's own initialization).  The drive's outcome is set by its
  initial map: the card's is the homography's other candidate, and the
  JAX engine starves from it near frame 84 as the port does (PERF.md,
  Findings).
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mageslam_tpu.mapping import culling as jcull
from mageslam_tpu.mapstore import map_state as jms
from mageslam_tpu.mapstore import pose_history as jph
from mageslam_tpu.tracking.frontend import FrameFeatures as JaxFeatures
from mageslam_tpu_torch import convert
from mageslam_tpu_torch.config import MageSlamSettings
from mageslam_tpu_torch.geometry import se3
from mageslam_tpu_torch.geometry.camera import CameraCalibration
from mageslam_tpu_torch.io import synthetic
from mageslam_tpu_torch.mapping import culling, global_ba
from mageslam_tpu_torch.mapstore import map_state as ms
from mageslam_tpu_torch.mapstore import pose_history as ph
from mageslam_tpu_torch.runtime import device_engine as de
from mageslam_tpu_torch.runtime.fossilized import FossilizedMap
from mageslam_tpu_torch.runtime.fused import MageSlamTorchFused
from mageslam_tpu_torch.runtime.slam import MageSlamTorch
from mageslam_tpu_torch.tracking.frontend import FrameFeatures
from test_torch_engine_loop import JaxKeyFactory
from test_torch_host_engine import POINT_RTOL, JaxChain, _tree, load_state
from test_torch_reloc import ring_calibration

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_torch_long_fixture import (FRACTION, KF_CAP, N,  # noqa: E402
                                     OUT, RADIUS)
from make_torch_ring_fixture import OUT as RING  # noqa: E402
from make_torch_ring_fixture import decode_frames  # noqa: E402

torch.set_num_threads(2)
ATOL = 1e-3
HOST_CODES = {"skipped": 0, "initializing": 1, "tracking": 2,
              "relocalizing": 3}
EXACT_MAP = ("kf_valid", "kf_frame_id", "kf_immortal", "num_kf_ever",
             "mp_valid", "mp_created_kf_gen", "kf_assoc")
EXACT_HISTORY = ("frame_id", "anchor_kf", "valid", "cursor")


@pytest.fixture(scope="module")
def z():
    return np.load(OUT)


def settings(z) -> MageSlamSettings:
    return MageSlamSettings.from_json(str(z["settings_json"]))


def calibration(z) -> CameraCalibration:
    fx, fy, cx, cy, w, h = z["cal"].tolist()
    return CameraCalibration(fx, fy, cx, cy, torch.as_tensor(z["cal_dist"]),
                             int(z["cal_model"]), int(w), int(h))


class Frames:
    """The drive's frames, rendered by the port and checked against the
    JAX renderer's CRC-32s (the fixture carries any it cannot render);
    each is rendered once per session."""

    rendered: dict = {}

    def __init__(self, z):
        self.z = z
        self.world = synthetic.SyntheticWorld.create_ring(900, seed=5)
        self.cal = synthetic.default_calibration()
        self.poses = synthetic.loop_trajectory(N, radius=RADIUS,
                                               fraction=FRACTION)
        self.fix = {int(i): f for i, f in zip(z["fix_idx"],
                                              z["fix_frames"])}

    def __getitem__(self, i: int) -> np.ndarray:
        import zlib
        if i in self.fix:
            return self.fix[i]
        if i not in self.rendered:
            img = self.world.render(self.cal, self.poses[i], seed=100 + i)
            crc = zlib.crc32(np.ascontiguousarray(img).tobytes())
            assert crc == int(self.z["crcs"][i]), f"frame {i}: CRC differs"
            self.rendered[i] = img
        return self.rendered[i]


def leaf(z, event: str, name: str):
    """A leaf of the JAX state after the step (post states keep only the
    leaves the step changed)."""
    post = f"{event}_post/{name}"
    return z[post] if post in z.files else z[f"{event}_pre/{name}"]


def jax_map(z, prefix: str):
    return jms.MapState(**{f: jnp.asarray(z[prefix + f])
                           for f in jms.MapState._fields})


def jax_history(z, prefix: str):
    return jph.PoseHistory(**{f: jnp.asarray(z[prefix + f])
                              for f in jph.PoseHistory._fields})


def assert_map(mt, want, label: str, pos_atol: float = ATOL):
    """``want(field)`` -> the JAX array; integers and booleans exactly,
    poses and valid points within ``pos_atol``."""
    got = convert.to_numpy(mt)
    for f in EXACT_MAP:
        w = np.asarray(want(f))
        g = got[f]
        if g.dtype != w.dtype and w.dtype == np.uint32:
            g = g.view(np.uint32)
        np.testing.assert_array_equal(g, w, err_msg=f"{label}: map/{f}")
    np.testing.assert_allclose(got["kf_pose"], np.asarray(want("kf_pose")),
                               atol=pos_atol, err_msg=f"{label}: kf_pose")
    v = np.asarray(want("mp_valid"))
    np.testing.assert_allclose(got["mp_pos"][v],
                               np.asarray(want("mp_pos"))[v],
                               atol=pos_atol, rtol=POINT_RTOL,
                               err_msg=f"{label}: mp_pos")


def assert_history(ht, want, label: str):
    got = convert.to_numpy(ht)
    for f in EXACT_HISTORY:
        np.testing.assert_array_equal(got[f], np.asarray(want(f)),
                                      err_msg=f"{label}: history/{f}")
    v = np.asarray(want("valid"))
    np.testing.assert_allclose(got["rel_pose"][v],
                               np.asarray(want("rel_pose"))[v], atol=ATOL,
                               err_msg=f"{label}: history/rel_pose")


# ---------------------------------------------------------------------------
# the carried capacity steps

@pytest.mark.parametrize("event", ["cap", "stale"])
def test_carried_capacity_step(z, event):
    i = int(z[f"{event}_frame"])
    pre = f"{event}_pre/"
    ns = types.SimpleNamespace(**{k[len(pre):]: z[k] for k in z.files
                                  if k.startswith(pre)
                                  and "/" not in k[len(pre):]})
    st = convert.engine_state_from_npz(z, pre)
    n_pre = int(st.map.kf_valid.sum())
    assert n_pre == KF_CAP and int(st.pend_count) > 0 \
        and not bool(st.ba_active), "not a drain at capacity"
    key = jax.random.wrap_key_data(jnp.asarray(ns.key_data))
    eng = de.DeviceEngine(settings(z), calibration(z), device="cpu", seed=0,
                          sampler_factory=JaxKeyFactory(key))
    st2, out = eng.step(st, torch.as_tensor(Frames(z)[i]), i / 30.0, i)
    assert int(out[0]) == int(z["s1_codes"][i])

    def want(group):
        return lambda f: leaf(z, event, f"{group}/{f}")
    assert_map(st2.map, want("map"), f"frame {i}")
    assert_history(st2.history, want("history"), f"frame {i}")
    for f in ("pend_count", "pend_fid", "last_kf", "kf_sig_valid",
              "ba_active", "ba_center", "loops_closed"):
        np.testing.assert_array_equal(getattr(st2, f).numpy(),
                                      leaf(z, event, f), err_msg=f)
    # the step culled a keyframe to make room and put the new one into
    # its slot
    fid = int(ns.pend_fid[0])
    new = st2.map.kf_valid.numpy() & (st2.map.kf_frame_id.numpy() == fid)
    assert new.sum() == 1
    assert z[pre + "map/kf_valid"][new].all()
    assert (z[pre + "map/kf_frame_id"][new] != fid).all()


# ---------------------------------------------------------------------------
# the force cull and the recycling, function by function

def test_force_cull_insert_and_allocate(z):
    """``drain_pending``'s capacity branch on the ``cap_pre/`` map, then the
    insert it makes room for, each function live in both packages."""
    pre = "cap_pre/"
    st = convert.engine_state_from_npz(z, pre)
    jm, jh = jax_map(z, pre + "map/"), jax_history(z, pre + "history/")
    last = int(z[pre + "last_kf"])

    cres = culling.cull_keyframes(st.map, st.last_kf, 0.0, 1,
                                  window=KF_CAP)
    jres = jcull.cull_keyframes(jm, jnp.int32(last), jnp.float32(0.0),
                                jnp.int32(1), window=KF_CAP)
    dead = cres.kf_culled_mask
    np.testing.assert_array_equal(dead.numpy(),
                                  np.asarray(jres.kf_culled_mask))
    assert int(dead.sum()) == 1
    assert_map(cres.map, lambda f: getattr(jres.map, f), "cull")

    targets = ph.nearest_valid_kf(st.map.kf_valid, dead, st.map.kf_frame_id)
    jt = jph.nearest_valid_kf(jm.kf_valid, jres.kf_culled_mask,
                              jm.kf_frame_id)
    np.testing.assert_array_equal(targets.numpy(), np.asarray(jt))
    h = ph.reanchor(st.history, st.map.kf_pose, st.map.kf_valid, dead,
                    targets)
    jh2 = jph.reanchor(jh, jm.kf_pose, jm.kf_valid, jres.kf_culled_mask, jt)
    assert_history(h, lambda f: getattr(jh2, f), "reanchor")
    moved = (z[pre + "history/anchor_kf"] != np.asarray(jh2.anchor_kf)) \
        .any(1)
    assert moved.sum() > 0

    # the pending keyframe into the freed slot, its history entry onto it
    feats = FrameFeatures(*[r[0] for r in st.pend_feats])
    jf = {f: jnp.asarray(z[f"{pre}pend_feats/{f}"][0])
          for f in FrameFeatures._fields}
    fid = int(z[pre + "pend_fid"][0])
    m2, slot = ms.insert_keyframe(cres.map, st.pend_pose[0], feats,
                                  st.pend_assoc[0], fid)
    jm2, jslot = jms.insert_keyframe(
        jres.map, jnp.asarray(z[pre + "pend_pose"][0]), JaxFeatures(**jf),
        jnp.asarray(z[pre + "pend_assoc"][0]), fid)
    assert int(slot) == int(jslot) and bool(dead[int(slot)])
    assert_map(m2, lambda f: getattr(jm2, f), "insert")
    h2 = ph.anchor_frame_to_kf(h, fid, slot)
    jh3 = jph.anchor_frame_to_kf(jh2, fid, jslot)
    assert_history(h2, lambda f: getattr(jh3, f), "anchor_frame_to_kf")

    # new points into the point slots the map has freed
    rng = np.random.default_rng(5)
    n = 64
    pos = rng.normal(0.0, 2.0, (n, 3)).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    normal = (pos / np.linalg.norm(pos, axis=1, keepdims=True)) \
        .astype(np.float32)
    ok = rng.random(n) < 0.9
    m3, ids = ms.allocate_map_points(
        m2, torch.as_tensor(pos), convert.tensor_from_numpy(desc),
        torch.as_tensor(normal), slot, torch.as_tensor(ok))
    jm3, jids = jms.allocate_map_points(
        jm2, jnp.asarray(pos), jnp.asarray(desc), jnp.asarray(normal),
        jslot, jnp.asarray(ok))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    free = ~z[pre + "map/mp_valid"]
    assert free[ids.numpy()[ids.numpy() >= 0]].all()
    assert_map(m3, lambda f: getattr(jm3, f), "allocate")


def test_stale_association_guard(z):
    """The guard ``drain_pending`` applies before it inserts
    (``mageslam_tpu/runtime/device_engine.py:497-499``): the JAX drive has
    no drain whose pending associations meet a recycled point slot, so the
    ``cap_pre/`` state is given some.  Three associated points of the
    pending keyframe get a creation generation after the one it was queued
    at (their slots recycled), two are culled; the drain must link none of
    the five to its stale point (new points of the drain may take them)
    and keep every other tracked association, as the drain of the
    untouched state keeps all of them."""
    s, cal = settings(z), calibration(z)
    assoc = torch.as_tensor(z["cap_pre/pend_assoc"][0])
    feat = torch.nonzero(assoc >= 0)[:5, 0]
    pts = assoc[feat].long()
    fid = int(z["cap_pre/pend_fid"][0])
    outs = []
    for make_stale in (False, True):
        # a fresh state each time: a drain writes into some of its tensors
        state = convert.engine_state_from_npz(z, "cap_pre/")
        if make_stale:
            mp = state.map
            mp.mp_created_kf_gen[pts[:3]] = state.pend_gen[0] + 1
            mp.mp_valid[pts[3:]] = False
        eng = de.DeviceEngine(s, cal, device="cpu", seed=0)
        m = eng.drain_pending(state).map
        slot = int(torch.nonzero(m.kf_valid & (m.kf_frame_id == fid))[0, 0])
        outs.append(m.kf_assoc[slot].clone())
    plain, guarded = outs
    tracked = assoc >= 0
    assert torch.equal(plain[tracked], assoc[tracked])
    # the five may take points made by this drain, never their stale ones
    assert (guarded[feat] != pts.to(guarded.dtype)).all()
    rest = tracked.clone()
    rest[feat] = False
    assert torch.equal(guarded[rest], assoc[rest])


def test_history_ring_wraps(rng):
    """``add_pose`` for 80 frames into a 32-slot history (the cursor wraps
    twice), keyframes culled and their slots reused every 10 frames with
    ``reanchor``, then ``world_poses``: live in both packages."""
    K, H, frames = 8, 32, 80

    def poses(n):
        q = rng.normal(size=(n, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        return np.concatenate([q, rng.normal(0, 1, (n, 3))], 1) \
            .astype(np.float32)

    kf_pose = poses(K)
    kf_valid = np.ones(K, bool)
    kf_fid = np.arange(K, dtype=np.int32)
    ht, hj = ph.empty_history(H), jph.empty_history(H)
    for f in range(frames):
        if f % 10 == 9:
            dead = np.zeros(K, bool)
            dead[rng.choice(K, 2, replace=False)] = True
            tt = ph.nearest_valid_kf(torch.as_tensor(kf_valid),
                                     torch.as_tensor(dead),
                                     torch.as_tensor(kf_fid))
            tj = jph.nearest_valid_kf(jnp.asarray(kf_valid),
                                      jnp.asarray(dead), jnp.asarray(kf_fid))
            np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
            ht = ph.reanchor(ht, torch.as_tensor(kf_pose),
                             torch.as_tensor(kf_valid),
                             torch.as_tensor(dead), tt)
            hj = jph.reanchor(hj, jnp.asarray(kf_pose), jnp.asarray(kf_valid),
                              jnp.asarray(dead), tj)
            # the freed slots take new keyframes (slot recycling); new
            # arrays, since JAX may still be reading the old ones
            kf_pose, kf_fid = kf_pose.copy(), kf_fid.copy()
            kf_pose[dead] = poses(int(dead.sum()))
            kf_fid[dead] = K + f + np.arange(int(dead.sum()))
        pose = poses(1)[0]
        anchors = rng.choice(K, 4, replace=False).astype(np.int32)
        anchors[rng.random(4) < 0.2] = -1
        ht = ph.add_pose(ht, f, f / 30.0, torch.as_tensor(pose),
                         torch.as_tensor(anchors), torch.as_tensor(kf_pose))
        hj = jph.add_pose(hj, f, f / 30.0, jnp.asarray(pose),
                          jnp.asarray(anchors), jnp.asarray(kf_pose))
    assert int(ht.cursor) == frames % H
    assert_history(ht, lambda f: getattr(hj, f), "wrap")
    assert ht.frame_id.min() == frames - H
    pt, okt = ph.world_poses(ht, torch.as_tensor(kf_pose),
                             torch.as_tensor(kf_valid))
    pj, okj = jph.world_poses(hj, jnp.asarray(kf_pose), jnp.asarray(kf_valid))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert okt.sum() > 0
    np.testing.assert_allclose(pt.numpy()[okt.numpy()],
                               np.asarray(pj)[np.asarray(okj)], atol=ATOL)


def test_fossilize_after_the_capacity_step(z):
    """``fossilize`` on the map and history after the capacity step.  The
    trajectory (``FossilizedMap.from_state``: every valid history entry
    re-interpolated from the 40 keyframes, one of them just put into a
    culled keyframe's slot, its entries re-anchored) exactly: frame ids,
    poses within 1e-3, live in both packages.  Its global BA to the error
    floor is held by outcome: the LM steps of this 40-keyframe map part
    the two packages' keyframe poses by more than 1e-3 within its first
    chunk (float32 solves of a nearly
    singular system, summed in another order: the local BA's parity gap,
    ``tools/diagnose_ba_parity.py``), while the inlier MSE stays close, so
    the BA'd trajectory is held by its frame ids, its final inlier MSE
    within 1% of JAX's and its camera centres within 0.5% of the
    trajectory's extent.  Both limits lie below a skipped BA: the map
    before it has an inlier MSE 2.1% from JAX's floor and camera centres
    up to 25% of the extent from JAX's (after the floor: 0.05% and
    0.04%)."""
    from mageslam_tpu.runtime.fossilized import FossilizedMap as JaxFossil
    s = settings(z)

    def field(group, cls):
        return cls(**{f: convert.tensor_from_numpy(
            leaf(z, "cap", f"{group}/{f}")) for f in cls._fields})
    m, h = field("map", ms.MapState), field("history", ph.PoseHistory)
    jm = jms.MapState(**{f: jnp.asarray(leaf(z, "cap", "map/" + f))
                         for f in jms.MapState._fields})
    jh = jph.PoseHistory(**{f: jnp.asarray(leaf(z, "cap", "history/" + f))
                            for f in jph.PoseHistory._fields})
    raw, jraw = FossilizedMap.from_state(m, h), JaxFossil.from_state(jm, jh)
    np.testing.assert_array_equal(raw.frame_ids, np.asarray(jraw.frame_ids))
    np.testing.assert_allclose(raw.poses, np.asarray(jraw.poses), atol=ATOL)
    assert len(raw.frame_ids) >= 400

    lam = convert.tensor_from_numpy(leaf(z, "cap", "lam"))
    fx = float(calibration(z).fx)
    jmse = float(z["cap_fossil_mse"])
    jc = se3.camera_center(torch.as_tensor(z["cap_fossil_poses"])).numpy()
    extent = float(np.linalg.norm(jc.max(0) - jc.min(0)))

    def off(fossil, res):
        """(relative MSE gap, largest camera centre gap / extent)."""
        gap = np.linalg.norm(fossil.camera_centers() - jc, axis=1).max()
        return (abs(float(res.mean_sq_error) - jmse) / jmse,
                float(gap) / extent)
    # a skipped BA fails both limits
    _, res0 = global_ba.engine_global_bundle_adjust(m, s, fx, num_steps=0,
                                                    lam0=lam)
    skipped = off(raw, res0)
    assert skipped[0] > 0.01 and skipped[1] > 0.005, skipped

    chunk = max(int(s.graph_optimization.num_steps), 10)
    m, res = global_ba.global_ba_to_floor(m, s, fx, lam0=lam,
                                          chunk_steps=chunk)
    fossil = FossilizedMap.from_state(m, h)
    np.testing.assert_array_equal(fossil.frame_ids, z["cap_fossil_ids"])
    done = off(fossil, res)
    assert done[0] <= 0.01 and done[1] < 0.005, (done, skipped)


# ---------------------------------------------------------------------------
# the host engine's capacity guard

def host_drive(z, end: int):
    """``MageSlamTorch`` from the JAX host engine's state before its
    capacity guard first fires, over the ring's frames up to ``end``, on
    the JAX engine's key chain: (codes, keyframe counts, firings)."""
    s = MageSlamSettings.from_json(str(z["host_settings_json"]))
    start = int(z["host_pre_frame"])
    before = _tree(z, "host_pre/")
    with np.load(RING) as r:
        imgs, ts, cal = decode_frames(r), r["timestamps"], \
            ring_calibration(r)
    eng = MageSlamTorch(s, cal, device="cpu",
                        sampler_factory=JaxChain(before["key_data"]))
    load_state(eng, before)
    fired = []
    step = eng._mapping_step

    def guarded(fid, feats, pose, assoc):
        full = eng.num_keyframes >= eng._map.kf_valid.shape[0]
        r = step(fid, feats, pose, assoc)
        if full:
            fired.append((fid, r is not None))
        return r
    eng._mapping_step = guarded
    codes, kf = [], []
    for i in range(start, end):
        r = eng.process_frame(imgs[i], float(ts[i]))
        codes.append(HOST_CODES[r.state.value])
        kf.append((int(eng._map.num_kf_ever), int(eng._map.kf_valid.sum())))
    return np.array(codes), np.array(kf), fired


def want_fired(z, end: int):
    return [(int(f), bool(ok)) for f, ok in z["host_fired"] if f < end]


def test_host_engine_capacity_guard(z):
    """The frame of the guard's first firing, from the JAX host engine's
    state before it (``host_K`` = 9 slots, the ring's frame 31): the state
    code, the keyframe counts and the firing (a keyframe culled, the new
    one inserted) exactly.  The drive through the guard's later firings is
    ``test_host_engine_capacity_guard_drive`` (slow)."""
    start = int(z["host_pre_frame"])
    codes, kf, fired = host_drive(z, start + 1)
    np.testing.assert_array_equal(codes, z["host_codes"][start:start + 1])
    np.testing.assert_array_equal(kf, z["host_kf"][start:start + 1])
    assert fired == want_fired(z, start + 1) == [(start, True)]
    assert kf[0, 0] > kf[0, 1] == int(z["host_K"])


@pytest.mark.slow
def test_host_engine_capacity_guard_drive(z):
    """The same carried state driven over the rest of the ring's 130
    frames: codes, keyframe counts and the guard's 31 firings exactly.
    No float rounding parts the two engines within the drive: they agree
    on every frame from 31 to 129."""
    start = int(z["host_pre_frame"])
    end = len(z["host_codes"])
    codes, kf, fired = host_drive(z, end)
    same = (codes == z["host_codes"][start:end]) \
        & (kf == z["host_kf"][start:end]).all(1)
    first = start + int(np.argmin(same)) if not same.all() else end
    print(f"host drive: codes and keyframe counts equal on frames "
          f"{start}-{first - 1}; firings {len(fired)} (JAX "
          f"{len(want_fired(z, end))})")
    assert first == end
    assert fired == want_fired(z, end)


def test_host_engine_capacity_guard_drops_the_keyframe(z):
    """The guard's other exit: with every keyframe immortal (the drive's
    own immortals are the two of the initialization), nothing is cullable
    in either package's ``cull_keyframes``, so the frame of the guard's
    first firing is tracked as JAX tracked it and its keyframe dropped: no
    keyframe inserted, the map's keyframes as they were."""
    s = MageSlamSettings.from_json(str(z["host_settings_json"]))
    start = int(z["host_pre_frame"])
    before = _tree(z, "host_pre/")
    before["map/kf_immortal"] = before["map/kf_valid"].copy()
    jm = jms.MapState(**{f: jnp.asarray(before["map/" + f])
                         for f in jms.MapState._fields})
    last = int(before["scalar/last_kf"])
    jres = jcull.cull_keyframes(jm, jnp.int32(last), jnp.float32(0.0),
                                jnp.int32(1))
    assert int(jres.num_keyframes_culled) == 0
    with np.load(RING) as r:
        img, ts, cal = decode_frames(r)[start], r["timestamps"][start], \
            ring_calibration(r)
    eng = MageSlamTorch(s, cal, device="cpu",
                        sampler_factory=JaxChain(before["key_data"]))
    load_state(eng, before)
    cres = culling.cull_keyframes(eng._map, last, 0.0, 1)
    assert int(cres.num_keyframes_culled) == 0
    valid, ids = eng._map.kf_valid.clone(), list(eng._kf_frame_ids)
    calls = []
    step = eng._mapping_step

    def recorded(*args):
        calls.append(step(*args))
        return calls[-1]
    eng._mapping_step = recorded
    r = eng.process_frame(img, float(ts))
    assert r.state.value == "tracking" and int(z["host_codes"][start]) == 2
    assert calls == [None]
    assert torch.equal(eng._map.kf_valid, valid) and eng._kf_frame_ids == ids
    assert int(eng._map.num_kf_ever) == int(before["map/num_kf_ever"])


# ---------------------------------------------------------------------------
# drives from a stored initial map and from the port's own

class _Leaves(dict):
    """Stored leaves, read like an ``.npz``."""

    @property
    def files(self):
        return list(self)


def initial_state(z, start: str):
    """The engine state after the initialization frame: the JAX engine's
    (``init_post``) or the port's own on the card (``card_init``: its
    leaves that differ from JAX's)."""
    leaves = _Leaves({k: z[k] for k in z.files if k.startswith("init_post/")})
    if start == "card_init":
        leaves.update({"init_post/" + k[len("card_init/"):]: z[k]
                       for k in z.files if k.startswith("card_init/")})
    return convert.engine_state_from_npz(leaves, "init_post/")


def long_drive(z, n: int, start: str):
    """The facade over frames 0 to ``n`` - 1 with
    ``chip_smoke.long_drive``: from its own initialization (``own``), or
    with its state replaced after the initialization frame by a stored
    one, as ``chip_smoke.py``'s long-session phase drives it.  Returns the
    facade, its output rows and its own state after that frame."""
    import chip_smoke
    eng = MageSlamTorchFused(settings(z), calibration(z), seed=1,
                             device="cpu")
    resume = None if start == "own" else initial_state(z, start)
    rows, _, own = chip_smoke.long_drive(eng, Frames(z), n,
                                         int(z["init_frame"]), resume)
    return eng, rows, own


# the JAX engine's drives from each stored initial map
JAX_DRIVE = {"init_post": "s1_", "card_init": "ci_"}


@pytest.mark.parametrize("start", ["init_post", "card_init"])
def test_resume_from_the_jax_initialization(z, start):
    """Frames 0-14: the port's own initialization at frame 3, then a
    stored state after it (the JAX engine's, or the port's own on the
    card), the third-frame confirmation and the first keyframe: state codes
    and keyframes alive exactly as the JAX drive's from the same state."""
    n = 15
    eng, rows, _ = long_drive(z, n, start)
    p = JAX_DRIVE[start]
    assert int(z["init_frame"]) == 3
    np.testing.assert_array_equal(rows[:, 0].astype(int), z[p + "codes"][:n])
    np.testing.assert_array_equal(rows[:, 9].astype(int), z[p + "kf"][:n, 1])
    assert int(eng.state.map.num_kf_ever) == int(z[p + "kf"][n - 1, 0])


def test_card_initial_map_is_the_other_homography_candidate(z):
    """The port's own initial map on the card and the JAX engine's share
    the first keyframe and the rotation, and part in the translation's
    direction: the two candidates of the homography decomposition with
    equal cheirality counts, which the vote's reprojection term (about
    1e-6 against a count of about 200) cannot tell apart in float32."""
    jp = z["init_post/map/kf_pose"][:2]
    cp = z["card_init/map/kf_pose"][:2]
    np.testing.assert_array_equal(cp[0], jp[0])
    assert np.abs(cp[1, :4] - jp[1, :4]).max() < 0.01       # rotation
    cos = float(cp[1, 4:] @ jp[1, 4:]
                / np.linalg.norm(cp[1, 4:]) / np.linalg.norm(jp[1, 4:]))
    assert cos < 0.95, cos                                   # translation


@pytest.mark.slow
@pytest.mark.parametrize("start", ["own", "init_post", "card_init"])
def test_whole_long_drive(z, start):
    """The port's 640-frame drive on the CPU, held as ``chip_smoke.py``'s
    long-session phase holds it, to the JAX engine's drives from the same
    initial map: the port's own initialization (on this CPU it makes the
    JAX engine's map), JAX's, or the port's own on the card.  From JAX's
    map: tracked at least the lowest of seeds 1-3 minus 32 (5%), the last
    50 frames at least 40, capacity reached and held at every frame, the
    history at least 600 entries deep, ATE under ``ate_bound``; from the
    card's map, the bounds of the JAX drive from that map (``ci_*``)."""
    import chip_smoke
    eng, rows, own = long_drive(z, N, start)
    ref = "card" if start == "card_init" else "jax"
    if start == "own":
        assert chip_smoke.init_reference(np, own, z) == "jax"
    o = chip_smoke.long_outcome(np, eng, rows, z)
    cap = settings(z).capacity
    chip_smoke.check_long(o, chip_smoke.long_bounds(z, ref, cap), cap,
                          start)
