"""Write tests/data/torch_dataset.npz: the JAX console's drive of
``tests/data/mini_seq`` and the JAX package's goldens for the port's input
and checkpoint modules.

The port's console (``examples/console_torch.py``) reads the PNGs itself,
so the file holds no frames.  It holds:

- ``seq_*``: the fields of the JAX ``load_dataset(mini_seq)``: name, image
  paths relative to the repository, timestamps, the native calibration
  (``seq_cal`` = fx fy cx cy width height, ``seq_cal_dist``,
  ``seq_cal_model``), ground-truth timestamps and view poses, and
  ``tracking_calibration(320)`` and ``gt_for_frames()``;
- ``con_*``: the JAX console's golden path (``examples/console.py``: the
  frame pump, ``MageSlamTPUFused`` at ``fast_settings()``, ``fossilize``,
  the Sim3-aligned ATE of the fossil against the ground truth) at engine
  seeds 1, 2, 3: ``con_rows`` (3, 40, 24) output rows, ``con_tracked``,
  ``con_ate``, ``con_last_init`` (last INITIALIZING frame), seed 1's
  fossil (``con_fossil_ids``, ``con_fossil_poses``), the settings as JSON
  (``con_settings_json``) and ``con_ate_bound`` = 1.5x the worst ATE;
- ``cs_state/*``: seed 1's engine state after frame ``cs_frame``, the
  first tracking frame after its last initializing one (an earlier
  tracking frame can be an initialization that its third frame rejects),
  every leaf but the PRNG key;
- ``ckpt_bytes``: the JAX ``save_state`` checkpoint of that same state,
  the ``.npz`` file's bytes;
- ``ring_*``: the same console path over ``tests/data/ring_seq`` (150
  frames, no blackout) at seeds 1, 2, 3: rows, tracked counts, ATEs.

Run from the repository root (about 15 minutes on 8 CPU cores):

    JAX_PLATFORMS=cpu python tools/make_torch_dataset_fixture.py

Name parts (``ring_console_drive``, ...) to recompute only those and keep
the file's other keys.
"""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT / "tools"))
OUT = ROOT / "tests" / "data" / "torch_dataset.npz"
MINI_SEQ = ROOT / "tests" / "data" / "mini_seq"
RING_SEQ = ROOT / "tests" / "data" / "ring_seq"
SEEDS = (1, 2, 3)


def calibration_fields(cal, prefix: str) -> dict:
    return {prefix: np.array([cal.fx, cal.fy, cal.cx, cal.cy, cal.width,
                              cal.height], np.float64),
            f"{prefix}_dist": np.asarray(cal.dist, np.float32),
            f"{prefix}_model": np.int64(np.asarray(cal.model))}


def sequence_fields(out: dict):
    from mageslam_tpu.io.datasets import load_dataset
    seq = load_dataset(str(MINI_SEQ))
    out.update(
        seq_name=np.array(seq.name),
        seq_paths=np.array([str(Path(p).relative_to(ROOT))
                            for p in seq.image_paths]),
        seq_timestamps=seq.timestamps, seq_gt_timestamps=seq.gt_timestamps,
        seq_gt_poses=seq.gt_view_poses, seq_gt_for_frames=seq.gt_for_frames(),
        **calibration_fields(seq.calibration, "seq_cal"),
        **calibration_fields(seq.tracking_calibration(320), "seq_tracking"))


def snapshot(st):
    """The engine state as numpy leaves (the engine step donates its input
    buffers, so a later step deletes the arrays of this one), the PRNG key
    as its raw words."""
    import jax
    return jax.tree_util.tree_map(
        lambda x: np.array(x, copy=True),
        st._replace(key=jax.random.key_data(st.key)))


def console_drive(seed: int, root: Path = MINI_SEQ):
    """``examples/console.py``'s golden path at one engine seed; returns
    (rows, fossil, ATE, a snapshot of the state after each frame)."""
    from mageslam_tpu.io.datasets import load_dataset
    from mageslam_tpu.io.evaluation import ate_rmse
    from mageslam_tpu.io.native_loader import FramePump
    from mageslam_tpu.runtime.fused import MageSlamTPUFused
    from make_torch_fixture import _RowRecorder
    from test_slam_e2e import fast_settings

    seq = load_dataset(str(root))
    cal = seq.tracking_calibration(320)
    rows = _RowRecorder()
    eng = MageSlamTPUFused(fast_settings(), cal, seed=seed,
                           determinator=rows)
    states = []
    for i, img in FramePump(seq.image_paths, 320, cal.height, capacity=8,
                            n_threads=3):
        eng.process_frame(img, timestamp=float(seq.timestamps[i]
                                               - seq.timestamps[0]))
        states.append(snapshot(eng._state))
    eng.flush()
    fossil = eng.fossilize()
    gt = seq.gt_for_frames()
    fid_to_row = {int(f): k for k, f in enumerate(fossil.frame_ids)}
    keep = [(fid_to_row[i], i) for i in range(len(states))
            if i in fid_to_row]
    ate, _, _ = ate_rmse(np.stack([fossil.poses[k] for k, _ in keep]),
                         np.stack([gt[i] for _, i in keep]))
    return (np.stack([rows.rows[i] for i in range(len(states))]), fossil,
            ate, states)


def console_drives(out: dict):
    import jax
    import jax.numpy as jnp
    from mageslam_tpu.io.serialization import save_state
    from mageslam_tpu.runtime import device_engine as de
    from make_torch_fixture import _state_leaves
    from test_slam_e2e import fast_settings

    all_rows, tracked, ates, last_init = [], [], [], []
    for seed in SEEDS:
        t0 = time.perf_counter()
        rows, fossil, ate, states = console_drive(seed)
        codes = rows[:, 0].astype(int)
        all_rows.append(rows)
        tracked.append(int((codes == de.CODE_TRACKING).sum()))
        ates.append(ate)
        last_init.append(int(np.nonzero(codes == de.CODE_INITIALIZING)[0]
                             .max()))
        print(f"seed {seed}: tracked {tracked[-1]}/{len(rows)}, last "
              f"initializing frame {last_init[-1]}, ATE {ate:.5f} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
        if seed != SEEDS[0]:
            continue
        cs = last_init[-1] + 1
        assert codes[cs] == de.CODE_TRACKING
        out.update({f"cs_state/{k}": np.array(v, copy=True)
                    for k, v in _state_leaves(states[cs]).items()})
        out["cs_frame"] = np.int64(cs)
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "ckpt.npz"
            st = jax.tree_util.tree_map(jnp.asarray, states[cs])
            save_state(str(path), st._replace(
                key=jax.random.wrap_key_data(st.key)), {"frame": cs})
            out["ckpt_bytes"] = np.frombuffer(path.read_bytes(), np.uint8)
        out.update(con_fossil_ids=np.asarray(fossil.frame_ids),
                   con_fossil_poses=np.asarray(fossil.poses))
    out.update(con_rows=np.stack(all_rows),
               con_tracked=np.array(tracked, np.int64),
               con_ate=np.array(ates, np.float64),
               con_last_init=np.array(last_init, np.int64),
               con_ate_bound=np.float64(1.5 * max(ates)),
               con_settings_json=np.array(fast_settings().to_json()))


def ring_console_drive(out: dict):
    from mageslam_tpu.runtime import device_engine as de
    rows, tracked, ates = [], [], []
    for seed in SEEDS:
        r, _, ate, _ = console_drive(seed, RING_SEQ)
        rows.append(r)
        tracked.append(int((r[:, 0] == de.CODE_TRACKING).sum()))
        ates.append(ate)
        print(f"ring_seq, seed {seed}: tracked {tracked[-1]}/{len(r)}, ATE "
              f"{ate:.5f}", flush=True)
    out.update(ring_rows=np.stack(rows), ring_ate=np.array(ates),
               ring_tracked=np.array(tracked, np.int64))


PARTS = (sequence_fields, console_drives, ring_console_drive)


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
