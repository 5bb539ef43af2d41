"""The port's example program and tools against the JAX package's, on the
CPU.

- ``examples/run_synthetic_torch.py --frames 7 --cpu`` writes the fossil
  CSV and TUM files that its drive's ``fossilize`` exports (7 frames: the
  engine initializes and tracks; each later keyframe adds about 4 s of
  CPU time).
- ``io/real_texture.py``: the cloud (700 points, seed 3) and ring (900
  points, seed 5) worlds equal JAX's array for array.
- ``tools/make_dataset_torch.py``: frames 0-2 of the 40-frame orbit equal
  those of ``tools/make_dataset.py`` (0 grey levels), and so do the
  ground-truth rows (to float32 rounding).
- ``tools/bench_torch_matching.py``: its dense and node-masked matches
  equal the JAX tool's on the same draws.
- ``tools/bench_torch_scaling.py``: its problem is the JAX tool's (integers
  exact, projections to float32 rounding), and its 2-shard solve is
  ``sharded_lm``'s and lands within the distributed tolerances of JAX's
  single-device bundle adjustment.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "examples"))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import bench_torch_matching  # noqa: E402
import bench_torch_scaling  # noqa: E402
import make_dataset_torch  # noqa: E402
import run_synthetic_torch  # noqa: E402

torch.set_num_threads(2)


def test_run_synthetic_writes_the_fossil(tmp_path, capsys):
    csv, tum = tmp_path / "fossil.csv", tmp_path / "traj.tum"
    r = run_synthetic_torch.run(run_synthetic_torch.parse_args(
        ["--frames", "7", "--cpu", "--csv", str(csv), "--tum", str(tum)]))
    out = capsys.readouterr().out
    assert "[run_synthetic] 7 frames on cpu" in out
    assert f"tracked {r['tracked']}/7 frames" in out
    assert r["codes"].shape == (7,) and r["ate"] is None   # < 10 tracked
    assert r["tracked"] >= 1
    r["fossil"].export_csv(str(tmp_path / "want.csv"))
    r["fossil"].export_tum(str(tmp_path / "want.tum"))
    assert csv.read_text() == (tmp_path / "want.csv").read_text()
    assert tum.read_text() == (tmp_path / "want.tum").read_text()
    assert len(csv.read_text().splitlines()) == len(r["fossil"].frame_ids)


@pytest.mark.parametrize("kind,n,seed", [("cloud", 700, 3),
                                         ("ring", 900, 5)])
def test_real_texture_worlds_equal_jax(kind, n, seed):
    pytest.importorskip("matplotlib")
    from mageslam_tpu.io import real_texture as jrt
    from mageslam_tpu_torch.io import real_texture as trt
    make = {"cloud": "create_real_cloud", "ring": "create_real_ring"}[kind]
    want = getattr(jrt, make)(n, seed=seed)
    got = getattr(trt, make)(n, seed=seed)
    for f in (f.name for f in dataclasses.fields(want)):
        a, b = getattr(got, f), getattr(want, f)
        if a is None or b is None:
            assert a is None and b is None, f
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f)


def test_make_dataset_frames_equal_jax(tmp_path):
    pytest.importorskip("matplotlib")
    from PIL import Image

    from mageslam_tpu.geometry import se3
    from mageslam_tpu.io.real_texture import create_real_cloud
    from mageslam_tpu.io.synthetic import (default_calibration,
                                           orbit_trajectory)
    # tools/make_dataset.py's orbit, its first three frames
    cal = default_calibration()
    world = create_real_cloud(700, seed=3)
    poses = orbit_trajectory(40, radius=2.0, forward=0.02, sweep=0.9)[:3]
    want = [np.clip(world.render(cal, p, seed=900 + i), 0, 255)
            .astype(np.uint8) for i, p in enumerate(poses)]
    want_gt = np.array([np.concatenate([
        np.asarray(se3.camera_center(jnp.asarray(p))),
        np.asarray(se3.pose_inverse(jnp.asarray(p)))[:4]]) for p in poses])

    tworld, tposes = make_dataset_torch.scenario("orbit", 40)
    np.testing.assert_array_equal(tposes[:3], poses)
    make_dataset_torch.write_euroc(str(tmp_path), tworld, tposes[:3])
    cam = tmp_path / "mav0" / "cam0"
    names = [ln.split(",")[1] for ln in
             (cam / "data.csv").read_text().splitlines()[1:]]
    assert len(names) == 3
    for i, name in enumerate(names):
        got = np.asarray(Image.open(cam / "data" / name))
        np.testing.assert_array_equal(got, want[i], err_msg=f"frame {i}")
    gt = np.loadtxt(tmp_path / "mav0" / "state_groundtruth_estimate0"
                    / "data.csv", delimiter=",", ndmin=2)
    np.testing.assert_allclose(gt[:, 1:], want_gt, atol=1e-6)


def test_matching_tool_equals_jax():
    from mageslam_tpu.ops import matching as jm
    n = 96
    rng = np.random.default_rng(0)
    da, db, va, vb = bench_torch_matching.problem(n, rng, "cpu")
    na, nb = bench_torch_matching.draw_nodes(n, rng, "cpu")
    # the JAX tool's draws, in its order
    jrng = np.random.default_rng(0)
    ja = jnp.asarray(jrng.integers(0, 2**32, (n, 8), dtype=np.uint32))
    jb = jnp.asarray(jrng.integers(0, 2**32, (n, 8), dtype=np.uint32))
    jna, jnb = (jnp.asarray(jrng.integers(0, 64, n)) for _ in range(2))
    np.testing.assert_array_equal(na.numpy(), jna)
    np.testing.assert_array_equal(nb.numpy(), jnb)
    ones = jnp.ones(n, bool)
    np.testing.assert_array_equal(da.numpy().view(np.uint32), ja)
    # the near half of b copies a's words with a few bits flipped, so some
    # pairs match (random words alone lie ~128 bits apart)
    flip = np.uint32(1) << jrng.integers(0, 32, (n // 2, 8)).astype(np.uint32)
    jb = jb.at[: n // 2].set(ja[: n // 2] ^ jnp.asarray(
        flip * (jrng.random((n // 2, 8)) < 0.3)))
    db = torch.as_tensor(np.array(jb).view(np.int32))
    # and shares their nodes, so the node-masked match finds them too
    jnb = jnb.at[: n // 2].set(jna[: n // 2])
    nb = torch.as_tensor(np.array(jnb))

    idx, dist = bench_torch_matching.dense(da, db, va, vb)
    jidx, jdist = jm.match(ja, jb, ones, ones)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(dist.numpy(), jdist)
    assert (idx.numpy() >= 0).sum() >= n // 4

    got = bench_torch_matching.node_masked(da, db, va, vb, na, nb)
    d = jm.hamming_matrix(ja, jb)
    d = jnp.where((jna[:, None] == jnb[None, :]) & ones[:, None]
                  & ones[None, :], d, jm.BIG)
    best, _, jidx2 = jm._top2_min(d)
    np.testing.assert_array_equal(got.numpy(),
                                  jnp.where(best <= 50, jidx2, -1))
    assert (got.numpy() >= 0).any()


def test_scaling_tool_problem_and_solve():
    from mageslam_tpu.geometry import se3
    from mageslam_tpu.solvers import pnp
    from mageslam_tpu.solvers.bundle_adjust import (BAProblem,
                                                    bundle_adjust,
                                                    empty_tethers)
    from mageslam_tpu_torch.parallel import distributed_ba as dba
    K, L, M = 8, 64, bench_torch_scaling.OBS_PER_POINT
    got = bench_torch_scaling.scaling_problem(K, L, "cpu")
    # tools/bench_scaling.py's problem, built as it builds it
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-4, 4, L), rng.uniform(-3, 3, L),
                    rng.uniform(4, 12, L)], -1).astype(np.float32)
    poses = np.stack([np.asarray(se3.make_pose(
        se3.so3_exp(jnp.array([0.0, 0.02 * k, 0.0])),
        jnp.array([0.1 * k, 0.0, 0.0]))) for k in range(K)])
    obs_kf = np.asarray(rng.integers(0, K, (L, M)), np.int32)
    obs_xn = np.zeros((L, M, 2), np.float32)
    for m_i in range(M):
        xn, _ = pnp.project_normalized(
            jnp.asarray(poses)[jnp.asarray(obs_kf[:, m_i])],
            jnp.asarray(pts))
        obs_xn[:, m_i] = np.asarray(xn)
    obs_xn += rng.normal(0, 5e-4, obs_xn.shape).astype(np.float32)
    want = BAProblem(
        kf_poses=jnp.asarray(poses), kf_fixed=jnp.asarray(np.arange(K) < 2),
        points=jnp.asarray(pts + rng.normal(0, 0.05, (L, 3))
                           .astype(np.float32)),
        point_valid=jnp.ones(L, bool), obs_kf=jnp.asarray(obs_kf),
        obs_xn=jnp.asarray(obs_xn), obs_valid=jnp.ones((L, M), bool),
        **{k: jnp.asarray(v) for k, v in empty_tethers(1).items()})
    for f in want._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f)
        else:
            np.testing.assert_allclose(a, b, atol=1e-6, err_msg=f)

    steps = 3
    res = bench_torch_scaling.solve(
        *bench_torch_scaling.shard(got, ["cpu", "cpu"]), steps)
    mesh = dba.make_mesh(devices=["cpu", "cpu"])
    sp = dba.shard_problem(got, mesh)
    direct = dba.sharded_lm(mesh, sp.shards, [0, 0], sp.replicated,
                            bench_torch_scaling.HUBER,
                            bench_torch_scaling.MAX_OUTLIER, steps, 1e-4)
    for f in ("kf_poses", "points", "mean_sq_error", "lam"):
        assert torch.equal(getattr(res, f), getattr(direct, f)), f
    rj = bundle_adjust(want, jnp.float32(bench_torch_scaling.HUBER),
                       jnp.float32(bench_torch_scaling.MAX_OUTLIER),
                       num_steps=steps)
    np.testing.assert_allclose(res.kf_poses.numpy(), np.asarray(rj.kf_poses),
                               atol=1e-4)
    np.testing.assert_allclose(res.points.numpy(), np.asarray(rj.points),
                               atol=1e-3)
    np.testing.assert_allclose(float(res.mean_sq_error),
                               float(rj.mean_sq_error), rtol=1e-3)
