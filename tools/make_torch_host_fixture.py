"""Write tests/data/torch_host.npz: drives of the JAX package's host engine
(``mageslam_tpu/runtime/slam.py``, ``MageSlamTPU``), the goldens of the
port's ``MageSlamTorch``.

The file holds no frames: they come from ``tests/data/mini_seq``,
``tests/data/torch_orbit60.npz`` and ``tests/data/torch_ring150.npz``.
It holds:

- ``con_*``: the JAX console's golden path with ``--host-engine``
  (``examples/console.py``: the frame pump, ``fast_settings()``,
  ``fossilize``, the Sim3-aligned ATE against the ground truth) at engine
  seeds 1, 2, 3: per-frame state codes ``con_codes`` (3, 40) (0 skipped,
  1 initializing, 2 tracking, 3 relocalizing), ``con_tracked``,
  ``con_ate``, ``con_ate_bound`` = 1.5x the worst ATE, seed 1's poses
  (``con_poses``, NaN where not tracked) and fossil
  (``con_fossil_ids``/``_poses``), and the settings as JSON;
- ``det_*``: seed 1's determinator streams (``det_<channel>`` uint32
  hashes) and, for the frames before ``det_frames``, every checkpoint's
  values (``detv_<channel>_<index>_<value>``) and its frame id;
- ``orb_*``: the host engine over the 60-frame orbit of
  ``torch_orbit60.npz`` at ``bench.py``'s ``ref_settings()`` (440
  features, 256 keyframes, 8192 points; loop closure on): codes, tracked,
  ATE and bound (1.5x);
- ``bo_*``: the blackout drive, the 150 ring frames of
  ``torch_ring150.npz`` (frames 130-137 blacked out) at its ``ring_fast``
  settings (``loop_settings()`` of ``tests/test_e2e_loop_reloc.py`` with
  the ring's keyframe cadence): codes, tracked, the first relocalizing
  frame, the recovery frame, the loop attempts that ran a detection,
  ATE;
- ``ev_<event>/before/*`` and ``ev_<event>/after/*``: seed 1's carried
  host state (map, history, BoW database, host scalars, init buffer and
  training descriptors, the PRNG key's raw words) before and after one
  ``process_frame`` (or ``fossilize``) of each event: ``init`` (the
  drive's last successful initialization), ``confirm`` (the third-frame
  confirmation that keeps it),
  ``track`` (a tracked frame whose keyframe decision is no, window
  converged), ``reject`` (a third-frame confirmation that rejects its
  initialization), ``polish`` (an idle-time polish), ``keyframe`` (a mapping
  step), ``fossilize`` (on the console drive), ``reloc`` (a failed
  relocalization attempt) and ``loop`` (a keyframe whose loop attempt runs
  a detection) on the blackout drive; ``ev_<event>_frame`` and
  ``ev_<event>_drive`` say which frame of which drive, ``ev_<event>_result``
  its code and pose; ``ev_init/essential/*`` the result of the essential
  RANSAC inside that initialization attempt.  An after-state keeps of the
  keyframes' features and the points' descriptors only the rows the step
  changed, to stay small.

Run from the repository root (about 4 minutes on 8 CPU cores):

    JAX_PLATFORMS=cpu python tools/make_torch_host_fixture.py

Name parts (``orbit_drive``, ...) to recompute only those and keep the
file's other keys.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT / "tools"))
OUT = ROOT / "tests" / "data" / "torch_host.npz"
MINI_SEQ = ROOT / "tests" / "data" / "mini_seq"
SEEDS = (1, 2, 3)
DET_FRAMES = 12           # checkpoint values kept for the frames before
CODES = {"skipped": 0, "initializing": 1, "tracking": 2, "relocalizing": 3}
# fields of an after-state kept as the rows that changed (the keyframes'
# features and the points' descriptors: large, and changed in a few rows)
CHANGED_ROWS = ("map/kf_uv", "map/kf_xn", "map/kf_desc", "map/kf_octave",
                "map/kf_feat_valid", "map/mp_desc")
SCALARS = ("_initialized", "_frame_id", "_last_kf", "_frames_since_kf",
           "_frames_since_reloc", "_lost_count", "_lam", "_covis_threshold",
           "_bow_trained", "_loops_closed", "_ba_converged",
           "_init_probation", "_init_points")


def host_state(eng) -> dict:
    """The host engine's carried state as numpy leaves."""
    import jax
    out = {}
    for group, tup in (("map", eng._map), ("history", eng._history),
                       ("bow/vocab", eng._bow.vocab)):
        for f in tup._fields:
            out[f"{group}/{f}"] = np.array(getattr(tup, f), copy=True)
    out["bow/kf_sig"] = np.array(eng._bow.kf_sig, copy=True)
    out["bow/kf_valid"] = np.array(eng._bow.kf_valid, copy=True)
    for name in SCALARS:
        out[f"scalar/{name[1:]}"] = np.asarray(getattr(eng, name))
    for name in ("_pose_prev", "_pose_prev2"):
        v = getattr(eng, name)
        out[f"pose/{name[1:]}"] = (np.full(7, np.nan, np.float32) if v is None
                                   else np.array(v, np.float32))
    out["kf_frame_ids"] = np.asarray(eng._kf_frame_ids, np.int64)
    out["key_data"] = np.array(jax.random.key_data(eng._key))
    buf = eng._init_buffer
    out["init/fid"] = np.asarray([f for f, _, _ in buf], np.int64)
    out["init/ts"] = np.asarray([t for _, t, _ in buf], np.float64)
    if buf:
        for f in buf[0][2]._fields:
            out[f"init/feats/{f}"] = np.stack(
                [np.asarray(getattr(ft, f)) for _, _, ft in buf])
    tr = eng._bow_training
    out["train/count"] = np.int64(len(tr))
    if tr:
        out["train/desc"] = np.stack([np.asarray(d) for d, _ in tr])
        out["train/valid"] = np.stack([np.asarray(v) for _, v in tr])
    return out


def after_fields(before: dict, after: dict) -> dict:
    """An after-state without the init buffer and training descriptors,
    its keyframe features and point descriptors as the rows that changed
    (``<field>/idx``, ``<field>/rows``)."""
    out = {}
    for k, v in after.items():
        if k in CHANGED_ROWS:
            w = before[k]
            idx = np.nonzero((v != w).reshape(len(v), -1).any(-1))[0]
            out[k + "/idx"] = idx.astype(np.int64)
            out[k + "/rows"] = v[idx]
        elif not k.startswith(("init/", "train/")):
            out[k] = v
    return out


class ValueDeterminator:
    """A JAX ``Determinator`` that also keeps the values of the checkpoints
    of the first ``frames`` frames."""

    def __init__(self, frames: int):
        from mageslam_tpu.utils.determinism import Determinator
        self.det = Determinator()
        self.frames = frames
        self.values: dict = {}

    def check(self, channel, fid, *values):
        self.det.check(channel, fid, *values)
        if fid < self.frames:
            n = len(self.det.streams[channel]) - 1
            self.values[(channel, n)] = (fid, [np.array(v) for v in values])


def result_fields(prefix: str, r) -> dict:
    return {f"{prefix}_code": np.int64(CODES[r.state.value]),
            f"{prefix}_pose": (np.full(7, np.nan, np.float32)
                               if r.pose is None
                               else np.asarray(r.pose, np.float32))}


def classify(before: dict, after: dict, r) -> str | None:
    """The event a frame of a drive is, from its states and result."""
    if not before["scalar/initialized"]:
        return "init" if after["scalar/initialized"] else None
    if before["scalar/init_probation"]:
        return "confirm" if r.state.value == "tracking" else "reject"
    if r.state.value != "tracking":
        return None
    if after["map/num_kf_ever"] > before["map/num_kf_ever"]:
        return "keyframe"
    if not before["scalar/ba_converged"]:
        return "polish"
    return "track"


def essential_of_attempt(eng, args) -> dict:
    """The essential RANSAC's result inside an initialization attempt,
    recomputed as ``attempt_initialization`` runs it: the partner the
    engine picks, the attempt's subkey of the key it held, its matches and
    weights (``tests/test_torch_init_track_map.py`` builds it the same
    way)."""
    import jax
    import jax.numpy as jnp
    from mageslam_tpu.ops import matching
    from mageslam_tpu.solvers import essential
    feats, ts, key, buf = args
    s = eng.settings.mono.map_init
    buf = [b for b in buf + [(None, ts, feats)]
           if ts - b[1] <= s.max_initialization_interval_ms / 1000.0]
    f0 = [ft for _, t, ft in buf
          if ts - t >= s.min_initialization_interval_ms / 1000.0][-1]
    kE, _ = jax.random.split(jax.random.split(key)[1])
    idx, dist = matching.match(
        f0.desc, feats.desc, f0.valid & (f0.octave == 0),
        feats.valid & (feats.octave == 0),
        max_distance=s.five_point_matching.max_hamming_distance,
        min_difference=s.five_point_matching.min_hamming_difference)
    px = 1.0 / float(eng.cal.fx)
    res = essential.essential_ransac(
        kE, f0.xn_undist, feats.xn_undist[jnp.clip(idx, 0)], idx >= 0,
        inlier_thresh=jnp.float32(s.fundamental_transfer_error_threshold
                                  * px),
        min_pixel_spread=jnp.float32(s.min_pixel_spread * px),
        num_hypotheses=1024,
        sample_weight=jnp.exp(-dist.astype(jnp.float32) / 12.0))
    return {f"essential/{f}": np.array(getattr(res, f))
            for f in res._fields}


def console_drive(seed: int, out: dict, capture: bool):
    from mageslam_tpu.io.datasets import load_dataset
    from mageslam_tpu.io.evaluation import ate_rmse
    from mageslam_tpu.io.native_loader import FramePump
    from mageslam_tpu.runtime.slam import MageSlamTPU
    from test_slam_e2e import fast_settings

    seq = load_dataset(str(MINI_SEQ))
    cal = seq.tracking_calibration(320)
    det = ValueDeterminator(DET_FRAMES) if capture else None
    eng = MageSlamTPU(fast_settings(), cal, seed=seed, determinator=det)
    attempts = []
    if capture:
        try_init = eng._try_initialize

        def recording_init(fid, ts, feats):
            attempts.append((feats, ts, eng._key, list(eng._init_buffer)))
            return try_init(fid, ts, feats)
        eng._try_initialize = recording_init
    codes, poses = [], []
    for i, img in FramePump(seq.image_paths, 320, cal.height, capacity=8,
                            n_threads=3):
        before = host_state(eng) if capture else None
        r = eng.process_frame(img, timestamp=float(seq.timestamps[i]
                                                   - seq.timestamps[0]))
        codes.append(CODES[r.state.value])
        poses.append(np.full(7, np.nan, np.float32) if r.pose is None
                     else np.asarray(r.pose, np.float32))
        if capture:
            after = host_state(eng)
            ev = classify(before, after, r)
            # the last initialization is the one the drive keeps
            if ev is not None and (ev == "init"
                                   or f"ev_{ev}_frame" not in out):
                store_event(out, ev, "console", i, before, after, r)
                if ev == "init":
                    out.update({"ev_init/" + k: v for k, v in
                                essential_of_attempt(eng,
                                                     attempts[-1]).items()})
    if capture:
        before = host_state(eng)
    fossil = eng.fossilize()
    if capture:
        out["ev_fossilize_frame"] = np.int64(-1)
        out["ev_fossilize_drive"] = np.array("console")
        out.update({"ev_fossilize/before/" + k: v for k, v in before.items()})
        out.update({"ev_fossilize/after/" + k: v for k, v in
                    after_fields(before, host_state(eng)).items()})
        out.update(con_fossil_ids=np.asarray(fossil.frame_ids),
                   con_fossil_poses=np.asarray(fossil.poses))
        store_streams(out, det)
    gt = seq.gt_for_frames()
    ate, _, _ = ate_rmse(fossil.poses,
                         np.stack([gt[i] for i in fossil.frame_ids]))
    return np.array(codes), np.stack(poses), float(ate)


def store_event(out, ev, drive, i, before, after, r):
    for k in [k for k in out if k.startswith((f"ev_{ev}/", f"ev_{ev}_"))]:
        del out[k]
    out[f"ev_{ev}_frame"] = np.int64(i)
    out[f"ev_{ev}_drive"] = np.array(drive)
    out.update({f"ev_{ev}/before/" + k: v for k, v in before.items()})
    out.update({f"ev_{ev}/after/" + k: v
                for k, v in after_fields(before, after).items()})
    out.update(result_fields(f"ev_{ev}_result", r))
    print(f"  event {ev}: {drive} frame {i} ({r.state.value})", flush=True)


def store_streams(out, det):
    streams = det.det.streams
    out["det_channels"] = np.array(list(streams))
    out["det_frames"] = np.int64(det.frames)
    for ch, hashes in streams.items():
        out[f"det_{ch}"] = np.asarray(hashes, np.uint32)
    for (ch, n), (fid, vals) in det.values.items():
        out[f"detf_{ch}_{n}"] = np.int64(fid)
        for j, v in enumerate(vals):
            out[f"detv_{ch}_{n}_{j}"] = v


def console_drives(out: dict):
    from test_slam_e2e import fast_settings
    codes, ates = [], []
    for seed in SEEDS:
        t0 = time.perf_counter()
        c, poses, ate = console_drive(seed, out, capture=seed == SEEDS[0])
        codes.append(c)
        ates.append(ate)
        if seed == SEEDS[0]:
            out["con_poses"] = poses
        print(f"console seed {seed}: tracked {int((c == 2).sum())}/{len(c)}"
              f", ATE {ate:.5f} ({time.perf_counter() - t0:.0f} s)",
              flush=True)
    codes = np.stack(codes)
    out.update(con_codes=codes, con_tracked=(codes == 2).sum(1),
               con_ate=np.array(ates), con_ate_bound=np.float64(
                   1.5 * max(ates)),
               con_settings_json=np.array(fast_settings().to_json()))


def orbit_drive(out: dict):
    from bench import ref_settings
    from mageslam_tpu.geometry.camera import CameraCalibration
    from mageslam_tpu.io.evaluation import ate_rmse
    from mageslam_tpu.runtime.slam import MageSlamTPU
    from make_torch_fixture import OUT as ORBIT

    z = np.load(ORBIT)
    fx, fy, cx, cy, w, h = z["cal"].tolist()
    cal = CameraCalibration.pinhole(fx, fy, cx, cy, int(w), int(h))
    s = ref_settings()
    eng = MageSlamTPU(s, cal, seed=1)
    codes = [CODES[eng.process_frame(img, timestamp=i / 30.0).state.value]
             for i, img in enumerate(z["imgs"])]
    codes = np.array(codes)
    if not (codes == 2).any():
        raise SystemExit("the JAX host engine never initializes on the "
                         "orbit: use the synthetic orbit instead")
    fossil = eng.fossilize()
    ate, _, _ = ate_rmse(fossil.poses, z["gt_poses"][fossil.frame_ids])
    out.update(orb_codes=codes, orb_tracked=np.int64((codes == 2).sum()),
               orb_ate=np.float64(ate), orb_ate_bound=np.float64(1.5 * ate),
               orb_keyframes=np.int64(eng.num_keyframes),
               orb_settings_json=np.array(s.to_json()))
    print(f"orbit: tracked {int((codes == 2).sum())}/60, ATE {ate:.5f}, "
          f"{eng.num_keyframes} keyframes", flush=True)


def blackout_drive(out: dict):
    from mageslam_tpu.io.evaluation import ate_rmse
    from mageslam_tpu.loop import closure as jlc
    from mageslam_tpu.runtime.slam import MageSlamTPU
    from make_torch_ring_fixture import (OCC1, OUT as RING, decode_frames,
                                         fixture_settings)
    from test_torch_reloc import ring_calibration

    z = np.load(RING)
    imgs, ts = decode_frames(z), z["timestamps"]
    eng = MageSlamTPU(fixture_settings("ring_fast"), ring_calibration(
        z, jax_side=True), seed=1)
    # a loop attempt "runs a detection" when a candidate passes its gates:
    # detect_loop then reports inliers >= 0
    detections = []
    detect = jlc.detect_loop

    def counting(*a, **k):
        det = detect(*a, **k)
        if int(det.num_inliers) >= 0:
            detections.append(eng._frame_id - 1)
        return det
    jlc.detect_loop = counting
    codes = []
    try:
        for i, img in enumerate(imgs):
            before = host_state(eng)
            n_det = len(detections)
            r = eng.process_frame(img, timestamp=float(ts[i]))
            codes.append(CODES[r.state.value])
            after = host_state(eng)
            if "ev_reloc_frame" not in out and codes[-1] == 3 \
                    and codes[-2] == 3:
                store_event(out, "reloc", "blackout", i, before, after, r)
            if "ev_loop_frame" not in out and len(detections) > n_det:
                store_event(out, "loop", "blackout", i, before, after, r)
    finally:
        jlc.detect_loop = detect
    codes = np.array(codes)
    fossil = eng.fossilize()
    keep = [k for k, f in enumerate(fossil.frame_ids) if codes[f] == 2]
    ate, _, _ = ate_rmse(fossil.poses[keep],
                         z["gt_poses"][fossil.frame_ids[keep]])
    reloc = np.nonzero(codes == 3)[0]
    back = np.nonzero(codes[OCC1:] == 2)[0]
    out.update(bo_codes=codes, bo_tracked=np.int64((codes == 2).sum()),
               bo_first_reloc=np.int64(reloc[0]),
               bo_recovery=np.int64(OCC1 + back[0]),
               bo_detections=np.asarray(detections, np.int64),
               bo_loops_closed=np.int64(eng.loops_closed),
               bo_ate=np.float64(ate))
    print(f"blackout: tracked {int((codes == 2).sum())}/150, relocalizing "
          f"from {reloc[0]}, back at {OCC1 + back[0]}, detections at "
          f"{detections}, ATE {ate:.5f}", flush=True)


PARTS = (console_drives, orbit_drive, blackout_drive)


def main(names):
    import jax
    jax.config.update("jax_platforms", "cpu")
    parts = [p for p in PARTS if p.__name__ in names] if names else PARTS
    if len(parts) != len(names or PARTS):
        raise SystemExit(f"parts: {[p.__name__ for p in PARTS]}")
    out = dict(np.load(OUT)) if names else {}
    for part in parts:
        t0 = time.perf_counter()
        part(out)
        print(f"{part.__name__}: {time.perf_counter() - t0:.0f} s",
              flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size / 1e6:.2f} MB)")


if __name__ == "__main__":
    main(sys.argv[1:])
