"""Write tests/data/torch_init_attempts.npz: every initialization attempt of
the JAX fused engine over ``bench.py``'s first frames, with its draws' key.

``bench_torch.first_tracking_frames`` holds the median first tracking frame
over seeds 1-12 at ``fast_settings()``; the spread around it (JAX worst 10,
the port up to 17 on the CPU) is either a draw of the initialization RANSAC
or a difference in how often the two packages accept on the same draws.
This file lets ``tests/test_torch_init_rate.py`` tell the two apart: it
replays each of JAX's attempts through the port on JAX's own draws.

It holds:

- ``feat_<field>`` (20, F, ...): the JAX engine's ``FrameFeatures`` of each
  of the 20 frames (as the engine's step extracted them, for frames that
  took part in an attempt; from ``extract_for_settings`` for the others),
  so that the port's frontend plays no part;
- per attempt (A of them, over ``bench_torch.INIT_SEEDS``): ``att_seed``,
  ``att_partner`` and ``att_frame`` (the frame pair), ``att_key`` (A, 2)
  uint32 (the attempt's sub-key words: ``kE, kH = split(key)``), and the
  JAX result ``att_success``, ``att_num_matches``, ``att_used_h`` and
  ``att_num_points``.  An attempt is a frame of the init branch whose
  partner exists (the engine computes the attempt for every such frame
  and keeps it only then); ``att_success`` is the attempt's own verdict,
  before the engine's third-frame confirmation;
- ``att_ess_<field>``: each attempt's essential RANSAC result
  (``EssentialResult``), recomputed as ``attempt_initialization`` runs it
  from the attempt's key and features: its 5-point pool's candidates
  depend on the LAPACK build's SVD, so a test can inject it;
- ``init_first`` (12,): the first tracking frame of each seed's drive;
- ``settings_json``, ``cal``.

Run from the repository root (about 2 minutes on 8 CPU cores; clear
``.jax_cache`` first, since the engine is traced with a callback):

    rm -rf .jax_cache
    JAX_PLATFORMS=cpu python tools/make_torch_init_fixture.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT / "tools"))
OUT = ROOT / "tests" / "data" / "torch_init_attempts.npz"


def record_attempts(log: list):
    """Patch the JAX package's ``attempt_initialization`` so that each run
    of it inside the engine's compiled step reports its inputs and result
    to ``log`` (a host callback; the engine's program is otherwise the
    same)."""
    import jax
    from mageslam_tpu.tracking import initialization

    orig = initialization.attempt_initialization

    def host(key, f0_desc, f1_desc, f1, res):
        log.append(dict(key=np.array(key), f0_desc=np.array(f0_desc),
                        f1_desc=np.array(f1_desc),
                        f1={k: np.array(v) for k, v in f1.items()},
                        success=bool(res[0]), num_matches=int(res[1]),
                        used_h=bool(res[2]), num_points=int(res[3])))

    def wrapped(key, f0, f1, settings, fx):
        r = orig(key, f0, f1, settings, fx)
        jax.debug.callback(
            host, jax.random.key_data(key), f0.desc, f1.desc,
            f1._asdict(),
            (r.success, r.num_matches, r.used_homography, r.num_points),
            ordered=True)
        return r

    initialization.attempt_initialization = wrapped
    return orig


def essential_of(f0: dict, f1: dict, key, si, fx) -> dict:
    """The essential RANSAC inside ``attempt_initialization`` on one pair,
    from the attempt's key (``kE, kH = split(key)``)."""
    import jax
    import jax.numpy as jnp
    from mageslam_tpu.ops import matching
    from mageslam_tpu.solvers import essential
    f0 = {k: jnp.asarray(v) for k, v in f0.items()}
    f1 = {k: jnp.asarray(v) for k, v in f1.items()}
    kE, _ = jax.random.split(jax.random.wrap_key_data(jnp.asarray(key)))
    idx, dist = matching.match(
        f0["desc"], f1["desc"], f0["valid"] & (f0["octave"] == 0),
        f1["valid"] & (f1["octave"] == 0),
        max_distance=si.five_point_matching.max_hamming_distance,
        min_difference=si.five_point_matching.min_hamming_difference)
    px = 1.0 / float(fx)
    res = essential.essential_ransac(
        kE, f0["xn_undist"], f1["xn_undist"][jnp.clip(idx, 0)], idx >= 0,
        inlier_thresh=jnp.float32(si.fundamental_transfer_error_threshold
                                  * px),
        min_pixel_spread=jnp.float32(si.min_pixel_spread * px),
        num_hypotheses=1024,
        sample_weight=jnp.exp(-dist.astype(jnp.float32) / 12.0))
    return {f: np.array(getattr(res, f)) for f in res._fields}


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from bench_torch import INIT_FRAMES, INIT_SEEDS
    from make_torch_bench_fixture import bench_frames
    from mageslam_tpu.runtime.fused import MageSlamTPUFused
    from mageslam_tpu.tracking import initialization
    from mageslam_tpu.tracking.frontend import extract_for_settings
    from test_slam_e2e import fast_settings

    imgs, cal = bench_frames()
    imgs = imgs[:INIT_FRAMES]
    ts = [i / 30.0 for i in range(INIT_FRAMES)]
    s = fast_settings()
    si = s.mono.map_init
    log: list = []
    orig = record_attempts(log)
    try:
        eng = MageSlamTPUFused(s, cal, seed=1)
        per_seed, firsts = [], []
        for seed in INIT_SEEDS:
            eng.reset(seed=seed)
            n0 = len(log)
            for i, img in enumerate(imgs):
                eng.process_frame(img, timestamp=ts[i])
            results = eng.flush()
            jax.effects_barrier()
            codes = [results[i].state.value for i in range(INIT_FRAMES)]
            firsts.append(codes.index("tracking") if "tracking" in codes
                          else -1)
            per_seed.append(log[n0:])
    finally:
        initialization.attempt_initialization = orig

    # each frame's features, from the attempt in which it was the current
    # frame (the same frame's features are the same in every seed's drive)
    ref = {}
    for recs in per_seed:
        for rec in recs:
            key = rec["f1_desc"].tobytes()
            ref.setdefault(key, rec["f1"])
    fn = jax.jit(lambda img: extract_for_settings(
        img, cal, s.mono.camera, s.capacity.max_features))
    own = [fn(jnp.asarray(img, jnp.float32)) for img in imgs]
    frame_feats = []
    for i, f in enumerate(own):
        d = np.asarray(f.desc)
        got = ref.get(d.tobytes())
        frame_feats.append(got if got is not None
                           else {k: np.asarray(v)
                                 for k, v in f._asdict().items()})
    desc_to_frame = {frame_feats[i]["desc"].tobytes(): i
                     for i in range(INIT_FRAMES)}
    for recs in per_seed:
        for rec in recs:
            assert rec["f1_desc"].tobytes() in desc_to_frame, \
                "an attempt's frame has features no frame's own match"

    out = {"settings_json": np.array(s.to_json()),
           "cal": np.array([cal.fx, cal.fy, cal.cx, cal.cy, cal.width,
                            cal.height], np.float64),
           "init_first": np.array(firsts, np.int64),
           "init_seeds": np.array(INIT_SEEDS, np.int64)}
    for k in frame_feats[0]:
        out["feat_" + k] = np.stack([f[k] for f in frame_feats])
    att = {k: [] for k in ("seed", "partner", "frame", "key", "success",
                           "num_matches", "used_h", "num_points")}
    for seed, recs in zip(INIT_SEEDS, per_seed):
        for rec in recs:
            frame = desc_to_frame[rec["f1_desc"].tobytes()]
            partner = desc_to_frame.get(rec["f0_desc"].tobytes(), -1)
            # the engine's eligibility test, in its float32
            age = np.float32(ts[frame]) - np.float32(ts[max(partner, 0)])
            if partner < 0 or partner == frame \
                    or not (np.float32(si.min_initialization_interval_ms
                                       / 1000.0) <= age
                            <= np.float32(si.max_initialization_interval_ms
                                          / 1000.0)):
                continue        # no partner: the engine drops the attempt
            for k, v in (("seed", seed), ("partner", partner),
                         ("frame", frame), ("key", rec["key"]),
                         ("success", rec["success"]),
                         ("num_matches", rec["num_matches"]),
                         ("used_h", rec["used_h"]),
                         ("num_points", rec["num_points"])):
                att[k].append(v)
    for k, v in att.items():
        out["att_" + k] = np.asarray(v)
    out["att_key"] = out["att_key"].astype(np.uint32)
    ess = [essential_of(frame_feats[p], frame_feats[f], key, si, cal.fx)
           for p, f, key in zip(att["partner"], att["frame"], att["key"])]
    for k in ess[0]:
        out["att_ess_" + k] = np.stack([e[k] for e in ess])
    np.savez_compressed(OUT, **out)
    n, ok = len(att["seed"]), int(np.sum(att["success"]))
    print(f"first tracking frames {firsts}; {n} attempts, {ok} accepted; "
          f"wrote {OUT} ({OUT.stat().st_size / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
