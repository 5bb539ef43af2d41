"""``bench_torch.py`` against ``bench.py``: the same settings, frames,
kernel-table problem and contract, on the CPU.

- ``ref_settings()`` is ``bench.py``'s, by JSON.
- The port renders ``bench.py``'s frames 0, 1 and 249 bit for bit, and
  their CRC-32s are those stored from the JAX package's renderer in
  ``tests/data/torch_bench.npz`` (which ``chip_smoke.py`` checks on the
  card's host, where there is no JAX).
- The kernel table's local-BA problem holds JAX's arrays exactly; on a
  cut of it (24 cameras, 128 points, 2 LM steps) the port's BA takes
  JAX's accept decisions and is as close to the float64 solve as JAX is,
  by ``tests/test_torch_ba_parity.py``'s ratios.
- The device-step record: two steps from clones of one carried state (the
  orbit's state after frame 40, ``fast_settings()``) are equal, and the
  record has ``bench.py``'s keys and the host syncs; the profiler's keys
  are None off the card.
- A short bench drive gives its record, and the stdout line has
  ``bench.py``'s four keys; without a card ``main`` exits with code 2.
- At ``fast_settings()`` and seed 1 the port's drive over the bench's
  first frames initializes, its first tracking frame within 5 of the JAX
  engine's (the initialization RANSAC's draws set that frame, and torch's
  generator draws differently from ``jax.random``; ``chip_smoke.py``
  holds the spread over 12 seeds on the card).
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mageslam_tpu_torch import convert
from mageslam_tpu_torch.runtime import device_engine as de
from mageslam_tpu_torch.solvers.bundle_adjust import bundle_adjust_impl

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples"))
import bench  # noqa: E402
import bench_torch  # noqa: E402
from console_torch import fast_settings  # noqa: E402
from test_torch_ba_parity import MARGIN, RATIOS  # noqa: E402
from test_torch_engine import fixture_calibration  # noqa: E402

torch.set_num_threads(2)
DATA = os.path.join(os.path.dirname(__file__), "data")
BENCH = os.path.join(DATA, "torch_bench.npz")
ORBIT60 = os.path.join(DATA, "torch_orbit60.npz")
CUT_POINTS, CUT_STEPS = 128, 2


def test_ref_settings_are_bench_pys():
    want = bench.ref_settings().to_json()
    assert bench_torch.ref_settings().to_json() == want
    assert bench_torch.FRAME_CACHE_VERSION == bench.FRAME_CACHE_VERSION
    with np.load(BENCH) as z:
        assert str(z["bench_ref_settings_json"]) == \
            bench_torch.ref_settings().to_json()
        assert str(z["bench_fast_settings_json"]) == \
            fast_settings().to_json()
        assert str(z["rs_settings_json"]) == fast_settings().to_json()


def test_renders_bench_frames():
    from mageslam_tpu.io.synthetic import (SyntheticWorld,
                                           default_calibration,
                                           orbit_trajectory)
    idx = [0, 1, 249]
    cal = default_calibration()
    world = SyntheticWorld.create(700, seed=3)
    poses = orbit_trajectory(250, radius=2.0, forward=0.0032, sweep=0.9)
    want = [world.render(cal, poses[i], seed=500 + i) for i in idx]
    got = bench_torch.render_bench_frames(idx)
    for i, a, b in zip(idx, got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), f"frame {i}"
    with np.load(BENCH) as z:
        np.testing.assert_array_equal(bench_torch.frame_crcs(got),
                                      z["bench_crcs"][idx])


def jax_kernel_table_problem(settings):
    """``bench.py:80-96``'s problem, built as it builds it."""
    from mageslam_tpu.geometry import se3
    from mageslam_tpu.solvers.bundle_adjust import BAProblem, empty_tethers
    rng = np.random.default_rng(0)
    K, L, M = 24, settings.capacity.local_ba_points, 24
    pts = rng.uniform(-2, 2, (L, 3)).astype(np.float32) + [0, 0, 6]
    poses = jnp.tile(se3.pose_identity()[None], (K, 1))
    return BAProblem(
        kf_poses=poses, kf_fixed=jnp.arange(K) < 9,
        points=jnp.asarray(pts), point_valid=jnp.ones(L, bool),
        obs_kf=jnp.tile(jnp.arange(M, dtype=jnp.int32)[None], (L, 1)),
        obs_xn=jnp.asarray(rng.normal(0, 0.1, (L, M, 2)), jnp.float32),
        obs_valid=jnp.asarray(rng.random((L, M)) < 0.12),
        **{k: jnp.asarray(v) for k, v in empty_tethers(1).items()})


@pytest.fixture(scope="module")
def ba_problems():
    return (jax_kernel_table_problem(bench.ref_settings()),
            bench_torch.kernel_table_problem(bench_torch.ref_settings(),
                                             "cpu"))


def test_kernel_table_problem_is_bench_pys(ba_problems):
    want, got = ba_problems
    assert got.points.shape == (2048, 3)
    for name in want._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=name)


def test_kernel_table_ba_cut_matches_jax(ba_problems):
    """The cut is a random problem, far from any error floor and badly
    conditioned: JAX's own float32 poses sit 2e-3 from the float64 solve.
    So the port is held as ``tests/test_torch_ba_parity.py`` holds it:
    the same accept decisions (lambda), and a distance from the float64
    solve within that file's largest port-to-float64 ratio (with its
    margin) of JAX's own distance."""
    from mageslam_tpu.solvers.bundle_adjust import bundle_adjust
    want, got = ba_problems
    lm = ("points", "point_valid", "obs_kf", "obs_xn", "obs_valid")
    want = want._replace(**{f: getattr(want, f)[:CUT_POINTS] for f in lm})
    got = got._replace(**{f: getattr(got, f)[:CUT_POINTS] for f in lm})
    got64 = got._replace(**{f: getattr(got, f).double() for f in got._fields
                            if getattr(got, f).dtype == torch.float32})
    hd, moe = float(np.float32(0.007)), float(np.float32(0.027))
    rj = bundle_adjust(want, jnp.float32(hd), jnp.float32(moe),
                       num_steps=CUT_STEPS)
    rt = bundle_adjust_impl(got, hd, moe, num_steps=CUT_STEPS)
    r64 = bundle_adjust_impl(got64, hd, moe, num_steps=CUT_STEPS)
    assert float(rt.lam) == float(rj.lam) == float(r64.lam)
    bound = MARGIN * max(to64 for to64, _ in RATIOS.values())
    for name in ("kf_poses", "points", "mean_sq_error"):
        f64 = getattr(r64, name).numpy()
        d_jax = np.abs(np.asarray(getattr(rj, name)) - f64).max()
        d_port = np.abs(getattr(rt, name).numpy() - f64).max()
        assert d_port <= bound * d_jax, (name, d_port, d_jax)
    moved = np.abs(r64.kf_poses.numpy() - np.asarray(want.kf_poses)).max()
    assert moved > 1.0


def test_device_step_restep_is_equal():
    z = np.load(ORBIT60)
    st = convert.engine_state_from_npz(z, "fast_state40/", device="cpu")
    eng = de.DeviceEngine(fast_settings(), fixture_calibration(z),
                          device="cpu", seed=1)
    img = torch.as_tensor(z["imgs"][41])
    before = bench_torch.clone_state(st)
    rec = bench_torch.device_step(eng, st, img, chain=2, profiled=2)
    assert rec["restep_equal"] is True
    # the carried state was never written into
    assert bench_torch.states_equal(st, before)
    assert {"device_step_ms", "dispatch_ms_median", "host_syncs_per_step",
            "kernels_per_step", "kernel_ms_per_step"} <= set(rec)
    assert rec["device"] == "cpu" and rec["chain"] == 2
    assert rec["kernels_per_step"] is None        # not measured off the card
    assert rec["host_syncs_per_step"] >= 1        # the step's Python ifs
    json.dumps(rec)


def test_bench_drive_record_and_contract():
    from mageslam_tpu_torch.io.synthetic import default_calibration
    from mageslam_tpu_torch.runtime.fused import MageSlamTorchFused
    imgs = bench_torch.render_bench_frames(range(4))
    eng = MageSlamTorchFused(fast_settings(), default_calibration(), seed=1,
                             device="cpu")
    d = bench_torch.bench_drive(eng, imgs, warmup=2)
    assert d["codes"].shape == (4,) and d["fps"] > 0
    assert d["tracked"] == int((d["codes"][2:] == 2).sum())
    assert d["first_tracking"] == -1 or d["codes"][d["first_tracking"]] == 2
    assert d["host_syncs_per_frame"] > 0
    again = bench_torch.bench_drive(eng, imgs, warmup=2)
    np.testing.assert_array_equal(again["codes"], d["codes"])   # reset
    line = bench_torch.metric_line(12.3456)
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "tracked_frames_per_s_per_chip"
    assert line["vs_baseline"] == round(12.3456 / 30.0, 3)
    if not torch.cuda.is_available():
        assert bench_torch.main([]) == 2


def test_fast_drive_initializes_near_jax():
    with np.load(BENCH) as z:
        jfirst = int(z["init_first"][0])
        assert int(z["init_seeds"][0]) == 1
        # the JAX bench drive at fast_settings() from reset(seed=1) too
        assert jfirst == int(np.argmax(z["bench_fast_codes"] == 2))
    imgs = bench_torch.render_bench_frames(range(jfirst + 6))
    eng = bench_torch.make_engine(fast_settings(), "cpu")
    (first,) = bench_torch.first_tracking_frames(eng, imgs, seeds=(1,))
    assert first >= 0 and abs(first - jfirst) <= 5, (first, jfirst)
