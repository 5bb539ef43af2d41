"""Write tests/data/torch_long640.npz: the JAX engines at keyframe capacity,
the goldens of the port's long session.

``tests/test_long_session.py`` drives the JAX fused engine over a 640-frame
slow double loop with 40 keyframe slots, so that keyframe creation runs
past capacity: ``drain_pending``'s force cull, keyframe slot recycling,
history re-anchoring and ``fossilize`` over a churned map.  The file holds
no frames the port can render itself.  It holds:

- ``settings_json``: that test's ``long_settings()`` (``loop_settings()``
  of ``tests/test_e2e_loop_reloc.py`` with a 10-frame keyframe cadence,
  40 keyframes, 2048 points, a 1024-entry history); ``cal``, ``cal_dist``,
  ``cal_model``;
- ``gt_poses`` (640, 7) (``loop_trajectory(640, radius=3.0,
  fraction=2.24)``) and ``crcs`` (640,), the CRC-32 of each frame that
  ``SyntheticWorld.create_ring(900, seed=5)`` renders at render seed
  100 + i; ``fix_idx`` and ``fix_frames`` the frames whose CRC the port's
  renderer does not reproduce, as JAX rendered them (float32);
- for engine seeds 1, 2, 3 (``s<seed>_*``) of ``MageSlamTPUFused(settings,
  cal, seed)``: ``codes`` (640,) the state codes, ``kf`` (640, 2)
  ``(num_kf_ever, keyframes alive)`` after each frame, ``tracked``,
  ``last50`` (tracked among the last 50 frames), ``map_points``,
  ``history_valid``, ``loops``, ``ate`` (Sim(3)-aligned fossil ATE as that
  test computes it) and ``extent``; ``ate_bound`` = 1.5x the largest
  ATE (the JAX engine's own spread over its seeds, as
  ``make_torch_ring_fixture.seed_spread``);
- carried seed-1 states (every ``EngineState`` leaf, the PRNG key as raw
  words under ``<prefix>key_data``): ``cap_pre/`` after frame
  ``cap_frame`` - 1 and ``cap_post/`` after frame ``cap_frame``, the first
  step whose ``drain_pending`` meets a full map (a post state holds only
  the leaves that the step changed); ``stale_pre/`` and
  ``stale_post/`` around frame ``stale_frame``, the first drain that
  inserts into a slot a cull freed while its pending associations meet a
  point slot recycled since the keyframe was queued (``stale_kind`` says
  which case was found: ``recycled``, else ``culled`` for a point culled
  and not reused, else ``force_cull`` for the second force-cull step);
  ``init_post/`` after frame ``init_frame``, the engine's initialization
  (a drive resumed from it shares the JAX drive's initial map);
  ``cap_fossil_ids``/``_poses``: the JAX ``FossilizedMap`` of the
  ``cap_post/`` map and history after ``global_ba_to_floor``, whose last
  inlier mean square error is ``cap_fossil_mse``;
- the port's own initial map on the card and the JAX engine's drive from
  it: ``card_init/`` the leaves of the port's state after frame
  ``init_frame`` at seed 1 on an H100 that differ from ``init_post/``
  (``tools/probe_torch_long_init.py`` writes the whole state to
  ``_probe/long_own_init.npz``, git-ignored; part ``card_init`` reads
  it), and
  ``ci_*`` (the fields of ``s<seed>_*``) of ``MageSlamTPUFused(settings,
  cal, seed=1)`` with its state replaced by that one after frame
  ``init_frame`` (its own key kept);
- the host engine (``host_*``): ``MageSlamTPU`` on the ring's 130 frames
  before its blackout (``torch_ring150.npz``) at ``fast_settings()`` with
  ``host_K`` keyframe slots, the smallest at which it runs (below 8, one
  of its top-k windows is wider than the slots) and its capacity guard
  fires at least twice (``tests/data/mini_seq`` makes too few keyframes
  for that at 8 slots or more): per-frame ``host_codes``
  and ``host_kf``, ``host_fired`` (n, 2) (frame, 1 if the guard culled and
  inserted, 0 if nothing was cullable and the keyframe was dropped), the
  carried host state ``host_pre/`` before frame ``host_pre_frame`` (the
  first firing), and ``host_end/map/*`` after the last frame.

Run from the repository root (about 25 minutes on 8 CPU cores):

    JAX_PLATFORMS=cpu python tools/make_torch_long_fixture.py [part ...]

Parts are ``frames``, ``seed1``, ``seed2``, ``seed3``, ``host`` and
``card_init``; naming some recomputes only those and keeps the file's
other keys.  ``card_init`` needs the probe's file and ``init_post/``
(part ``seed1``).
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
OUT = ROOT / "tests" / "data" / "torch_long640.npz"
N, RADIUS, FRACTION, KF_CAP = 640, 3.0, 2.24, 40
SEEDS = (1, 2, 3)
PARTS = ("frames", "seed1", "seed2", "seed3", "host", "card_init")
OWN_INIT = ROOT / "_probe" / "long_own_init.npz"
HOST_K = range(8, 25)    # below 8, a top-k window is wider than the slots


def long_settings():
    from test_long_session import long_settings as settings
    return settings()


def render_frames():
    from mageslam_tpu.io.synthetic import (SyntheticWorld,
                                           default_calibration,
                                           loop_trajectory)
    world = SyntheticWorld.create_ring(900, seed=5)
    cal = default_calibration()
    gt = loop_trajectory(N, radius=RADIUS, fraction=FRACTION)
    return [world.render(cal, p, seed=100 + i)
            for i, p in enumerate(gt)], cal, np.asarray(gt, np.float64)


def frames_part(imgs, cal, gt) -> dict:
    from bench_torch import frame_crcs
    from mageslam_tpu_torch.io.synthetic import SyntheticWorld
    crcs = frame_crcs(imgs)
    world = SyntheticWorld.create_ring(900, seed=5)
    from mageslam_tpu_torch.io.synthetic import default_calibration
    pcal = default_calibration()
    own = frame_crcs([world.render(pcal, p, seed=100 + i)
                      for i, p in enumerate(gt)])
    bad = np.nonzero(own != crcs)[0]
    print(f"frames: {len(bad)} of {N} differ in the port's renderer",
          flush=True)
    return {"settings_json": np.array(long_settings().to_json()),
            "cal": np.array([cal.fx, cal.fy, cal.cx, cal.cy, cal.width,
                             cal.height], np.float64),
            "cal_dist": np.asarray(cal.dist, np.float32),
            "cal_model": np.int64(int(np.asarray(cal.model))),
            "gt_poses": gt, "crcs": crcs,
            "fix_idx": bad.astype(np.int64),
            "fix_frames": np.stack([imgs[i] for i in bad]).astype(np.float32)
            if len(bad) else np.zeros((0,) + imgs[0].shape, np.float32)}


def fossil_ate(results, fossil, gt) -> tuple[float, float]:
    """``test_fossil_ate_bounded``'s ATE and the trajectory's extent."""
    from mageslam_tpu.io.evaluation import ate_rmse
    from mageslam_tpu.runtime.slam import TrackingState
    est, ref = [], []
    for i in range(N):
        r = results.get(i)
        if r is not None and r.state == TrackingState.TRACKING:
            p = fossil.pose_for_frame(r.frame_id)
            if p is not None:
                est.append(p)
                ref.append(gt[i])
    rmse, _, gt_c = ate_rmse(np.asarray(est), np.asarray(ref))
    return float(rmse), float(np.linalg.norm(gt_c.max(0) - gt_c.min(0)))


def drains(pre: dict) -> bool:
    """Whether the step after ``pre`` drains a pending keyframe (the
    engine advances mapping before tracking: with no active window and a
    keyframe pending, the step pops it)."""
    return bool(pre["initialized"]) and not bool(pre["ba_active"]) \
        and int(pre["pend_count"]) > 0


def stale_kind(pre: dict) -> str | None:
    """Which case of the stale-association guard the next drain meets."""
    a = pre["pend_assoc"][0]
    gen = pre["pend_gen"][0]
    a = a[a >= 0]
    if (pre["map/mp_created_kf_gen"][a] > gen).any():
        return "recycled"
    if (~pre["map/mp_valid"][a]).any():
        return "culled"
    return None


def with_leaves(st, new: dict):
    """The JAX ``EngineState`` ``st`` with each leaf named in ``new`` (by
    slash-joined field path, as ``_state_leaves`` names them) replaced,
    cast to the leaf's dtype; ``st``'s key is kept."""
    import jax
    import jax.numpy as jnp
    from make_torch_fixture import _state_leaves
    names = list(_state_leaves(st))
    missing = [n for n in names if n not in new]
    assert not missing, f"leaves missing from the port's state: {missing}"
    old, tree = jax.tree_util.tree_flatten(st._replace(key=None))
    vals = [jnp.asarray(np.asarray(new[n]).astype(np.asarray(o).dtype)
                        .reshape(np.shape(o))) for n, o in zip(names, old)]
    return jax.tree_util.tree_unflatten(tree, vals)._replace(key=st.key)


def drive(seed: int, imgs, cal, gt, capture: bool, resume=None,
          p: str | None = None) -> dict:
    """The JAX drive at ``seed``, its outcome under ``p`` (default
    ``s<seed>_``); with ``resume`` = (frame, leaves), its state replaced
    by those leaves after that frame."""
    from make_torch_fixture import _RowRecorder
    from make_torch_ring_fixture import state_leaves
    from mageslam_tpu.runtime import device_engine as de
    from mageslam_tpu.runtime.fused import MageSlamTPUFused

    rec = _RowRecorder()
    eng = MageSlamTPUFused(long_settings(), cal, seed=seed, fetch_every=1,
                           determinator=rec)
    kf = np.zeros((N, 2), np.int64)
    out, pre, caps, stale = {}, None, [], None
    ever = np.zeros(KF_CAP, bool)       # slots that have held a keyframe
    kinds: dict = {}
    t0 = time.perf_counter()
    for i, img in enumerate(imgs):
        eng.process_frame(img, timestamp=i / 30.0)
        if resume is not None and i == resume[0]:
            eng._state = with_leaves(eng._state, resume[1])
        st = eng._state
        kf[i] = (int(st.map.num_kf_ever), int(np.asarray(st.map.kf_valid)
                                              .sum()))
        if not capture:
            continue
        cur = state_leaves(st, "")
        if "init_frame" not in out and bool(cur["initialized"]):
            out["init_frame"] = np.int64(i)
            out.update({"init_post/" + k: v for k, v in cur.items()})
        if pre is not None and drains(pre):
            if pre["map/kf_valid"].sum() >= KF_CAP and len(caps) < 2:
                caps.append((i, pre, cur))
            kind = stale_kind(pre)
            new = cur["map/kf_valid"] & (cur["map/kf_frame_id"]
                                         == pre["pend_fid"][0])
            recycled = bool((new & ever).any())
            kinds[(kind, recycled)] = kinds.get((kind, recycled), 0) + 1
            if kind is not None and recycled \
                    and (stale is None or (stale[0] == "culled"
                                           and kind == "recycled")):
                stale = (kind, i, pre, cur)
        ever |= cur["map/kf_valid"]
        pre = cur
        if i % 80 == 79:
            print(f"  seed {seed}: frame {i}, kf {kf[i].tolist()}, "
                  f"{time.perf_counter() - t0:.0f} s", flush=True)
    results = eng.flush()
    m, h = eng._state.map, eng._state.history
    rows = np.stack([rec.rows[i] for i in range(N)])
    codes = rows[:, 0].astype(np.int8)
    tracked = codes == de.CODE_TRACKING
    p = p or f"s{seed}_"
    out.update({p + "codes": codes, p + "kf": kf,
                p + "tracked": np.int64(tracked.sum()),
                p + "last50": np.int64(tracked[-50:].sum()),
                p + "map_points": np.int64(np.asarray(m.mp_valid).sum()),
                p + "history_valid": np.int64(np.asarray(h.valid).sum()),
                p + "loops": np.int64(eng.loops_closed)})
    fossil = eng.fossilize()
    out[p + "ate"], out[p + "extent"] = map(np.float64,
                                            fossil_ate(results, fossil, gt))
    print(f"{p}: tracked {int(tracked.sum())}/{N}, last 50 "
          f"{int(tracked[-50:].sum())}, kf ever/alive {kf[-1].tolist()}, "
          f"points {int(out[p + 'map_points'])}, history "
          f"{int(out[p + 'history_valid'])}, loops {eng.loops_closed}, ATE "
          f"{float(out[p + 'ate']):.3f} on {float(out[p + 'extent']):.3f}, "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    if capture:
        assert caps, "the drive never met a full map in a drain"
        i, a, b = caps[0]
        out["cap_frame"] = np.int64(i)
        out.update({"cap_pre/" + k: v for k, v in a.items()})
        out.update(changed("cap_post/", a, b))
        if stale is None:
            assert len(caps) > 1, "no second force-cull step"
            i, a, b = caps[1]
            stale = ("force_cull", i, a, b)
        out["stale_kind"] = np.array(stale[0])
        out["stale_frame"] = np.int64(stale[1])
        out.update({"stale_pre/" + k: v for k, v in stale[2].items()})
        out.update(changed("stale_post/", stale[2], stale[3]))
        out.update(cap_fossil(out, cal))
        print(f"drains by (stale kind, into a recycled slot): {kinds}",
              flush=True)
        print(f"cap step at frame {int(out['cap_frame'])}; stale step "
              f"({stale[0]}) at frame {stale[1]}", flush=True)
    return out


def changed(prefix: str, pre: dict, post: dict) -> dict:
    """The leaves of ``post`` that differ from ``pre`` (a reader takes the
    others from ``pre``), to keep the file small."""
    return {prefix + k: v for k, v in post.items()
            if not np.array_equal(v, pre[k])}


def cap_fossil(z: dict, cal) -> dict:
    """``fossilize``'s final global BA and trajectory on the ``cap_post/``
    map and history."""
    import jax.numpy as jnp
    from mageslam_tpu.mapping import global_ba
    from mageslam_tpu.mapstore.map_state import MapState
    from mageslam_tpu.mapstore.pose_history import PoseHistory
    from mageslam_tpu.runtime.fossilized import FossilizedMap
    s = long_settings()
    def leaf(name):
        return jnp.asarray(z.get("cap_post/" + name, z["cap_pre/" + name]))
    m = MapState(**{f: leaf("map/" + f) for f in MapState._fields})
    h = PoseHistory(**{f: leaf("history/" + f) for f in PoseHistory._fields})
    chunk = max(int(s.graph_optimization.num_steps), 10)
    m, res = global_ba.global_ba_to_floor(m, s, float(cal.fx),
                                          lam0=leaf("lam"),
                                          chunk_steps=chunk)
    fossil = FossilizedMap.from_state(m, h)
    return {"cap_fossil_ids": np.asarray(fossil.frame_ids),
            "cap_fossil_poses": np.asarray(fossil.poses),
            "cap_fossil_mse": np.float64(res.mean_sq_error)}


def card_init_part(z: dict, imgs, cal, gt) -> dict:
    """The port's own initial map on the card (the probe's file), as the
    leaves that differ from ``init_post/``, and the JAX drive from it."""
    with np.load(OWN_INIT) as own:
        leaves = {k: own[k] for k in own.files if k != "device"}
        print(f"card_init: the port's state on {own['device']}", flush=True)
    at = int(z["init_frame"])
    out = {"card_init/" + k: v for k, v in leaves.items()
           if not np.array_equal(v, z["init_post/" + k])}
    out.update(drive(1, imgs, cal, gt, capture=False, resume=(at, leaves),
                     p="ci_"))
    return out


def ring_frames():
    """The ring's frames before its blackout (``torch_ring150.npz``, the
    frames of ``tests/data/ring_seq``), timestamps and calibration."""
    from make_torch_ring_fixture import OCC0, OUT as RING, RING as SEQ
    from make_torch_ring_fixture import decode_frames
    from mageslam_tpu.io import datasets
    with np.load(RING) as z:
        imgs, ts = decode_frames(z)[:OCC0], z["timestamps"][:OCC0]
    return imgs, ts, datasets.load_dataset(str(SEQ)).tracking_calibration(320)


def host_drive(k: int, capture: bool) -> dict:
    from make_torch_host_fixture import CODES, host_state
    from mageslam_tpu.runtime.slam import MageSlamTPU
    from test_slam_e2e import fast_settings

    s = fast_settings()
    s = s.replace(capacity=dataclasses.replace(s.capacity, max_keyframes=k))
    imgs, ts, cal = ring_frames()
    eng = MageSlamTPU(s, cal, seed=1)
    fired: list = []
    step = eng._mapping_step

    def guarded(fid, feats, pose, assoc):
        full = eng.num_keyframes >= eng._map.kf_valid.shape[0]
        r = step(fid, feats, pose, assoc)
        if full:
            fired.append((fid, r is not None))
        return r
    eng._mapping_step = guarded
    codes, kf, pre = [], [], None
    for i, img in enumerate(imgs):
        before = host_state(eng) if capture and not fired else None
        n = len(fired)
        r = eng.process_frame(img, timestamp=float(ts[i]))
        if capture and n == 0 and fired:
            pre = (i, before)
        codes.append(CODES[r.state.value])
        kf.append((int(eng._map.num_kf_ever),
                   int(np.asarray(eng._map.kf_valid).sum())))
    out = {"host_K": np.int64(k), "host_codes": np.array(codes, np.int8),
           "host_kf": np.array(kf, np.int64),
           "host_fired": np.array(fired, np.int64).reshape(-1, 2),
           "host_settings_json": np.array(s.to_json())}
    if capture:
        out["host_pre_frame"] = np.int64(pre[0])
        out.update({"host_pre/" + k: v for k, v in pre[1].items()})
        out.update({"host_end/map/" + f: np.array(getattr(eng._map, f))
                    for f in eng._map._fields})
    return out


def host_part() -> dict:
    for k in HOST_K:
        t0 = time.perf_counter()
        try:
            o = host_drive(k, capture=False)
        except ValueError as e:
            # a top-k window of the engine (tracking's local map, new
            # points' candidates, culling) wider than the keyframe slots
            print(f"host K={k}: the JAX engine cannot run ({e})", flush=True)
            continue
        fired = o["host_fired"]
        print(f"host K={k}: guard fired {len(fired)} times "
              f"({int(fired[:, 1].sum())} culls) at frames "
              f"{fired[:, 0].tolist()}, tracked "
              f"{int((o['host_codes'] == 2).sum())}/{len(o['host_codes'])},"
              f" keyframes ever {int(o['host_kf'][-1, 0])}, "
              f"{time.perf_counter() - t0:.0f} s", flush=True)
        if len(fired) >= 2:
            return host_drive(k, capture=True)
    raise RuntimeError("the capacity guard never fired twice")


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    parts = sys.argv[1:] or list(PARTS)
    assert set(parts) <= set(PARTS), parts
    out = dict(np.load(OUT)) if OUT.exists() and len(parts) < len(PARTS) \
        else {}
    imgs, cal, gt = render_frames()
    if "frames" in parts:
        out.update(frames_part(imgs, cal, gt))
        np.savez_compressed(OUT, **out)
    for seed in SEEDS:
        if f"seed{seed}" in parts:
            out.update(drive(seed, imgs, cal, gt, capture=(seed == 1)))
            np.savez_compressed(OUT, **out)     # keep what is done so far
    if all(f"s{seed}_ate" in out for seed in SEEDS):
        out["ate_bound"] = np.float64(
            1.5 * max(float(out[f"s{seed}_ate"]) for seed in SEEDS))
    if "host" in parts:
        out.update(host_part())
    if "card_init" in parts:
        out.update(card_init_part(out, imgs, cal, gt))
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
