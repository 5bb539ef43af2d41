"""The port's distributed BA (``mageslam_tpu_torch/parallel/distributed_ba``)
against the JAX package's on the same inputs, and against its own
single-device solver, on an 8-shard CPU mesh (the counterpart of the JAX
tests' 8-device virtual CPU mesh).

Tolerances are those of ``tests/test_distributed_ba.py``: poses 1e-4,
points 1e-3, MSE relative 1e-3 (tethers: poses 5e-4).  In float64 the
distributed and single-device solves agree to 1e-7 on a perturbed problem
that they move by over 1e-3, so the reduction itself is checked apart from
float32 summation order.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mageslam_tpu.parallel import distributed_ba as jdba
from mageslam_tpu.solvers.bundle_adjust import TETHER_DISTANCE
from mageslam_tpu_torch import MageSlamSettings, convert
from mageslam_tpu_torch.geometry import se3
from mageslam_tpu_torch.mapping import global_ba
from mageslam_tpu_torch.parallel import distributed_ba as dba
from mageslam_tpu_torch.parallel.multiprocess import certification_map
from mageslam_tpu_torch.solvers.bundle_adjust import bundle_adjust
from tests.test_bundle_adjust import build_problem

torch.set_num_threads(2)
FIXTURE = Path(__file__).parent / "data" / "torch_parallel.npz"


@pytest.fixture(scope="module")
def mesh8():
    return dba.make_mesh(devices=["cpu"] * 8)


def _with_distance_tether(problem, poses_gt):
    c0 = se3.camera_center(torch.as_tensor(poses_gt[0]))
    c5 = se3.camera_center(torch.as_tensor(poses_gt[-1]))
    target = float(torch.linalg.vector_norm(c0 - c5))
    return problem._replace(
        tether_i=jnp.array([0], jnp.int32),
        tether_j=jnp.array([5], jnp.int32),
        tether_type=jnp.array([TETHER_DISTANCE], jnp.int32),
        tether_dist=jnp.array([target], jnp.float32),
        tether_weight=jnp.array([50.0], jnp.float32))


def _close(a, b, pose_atol=1e-4, point_atol=1e-3):
    assert float(a.mean_sq_error) == pytest.approx(
        float(b.mean_sq_error), rel=1e-3, abs=1e-9)
    np.testing.assert_allclose(np.asarray(a.kf_poses),
                               np.asarray(b.kf_poses), atol=pose_atol)
    np.testing.assert_allclose(np.asarray(a.points), np.asarray(b.points),
                               atol=point_atol)


def test_matches_jax_distributed(mesh8, rng):
    """The same problem, with a distance tether, through JAX's shard_map'd
    solver on its 8 virtual devices (tether weight scaled by 1/8 on each
    shard) and through the port's on 8 CPU shards (tether counted once
    after the reduction)."""
    problem, poses_gt, _ = build_problem(rng, K=6, L=128, M=6,
                                         obs_noise=3e-4, T=1)
    problem = _with_distance_tether(problem, poses_gt)
    jmesh = jdba.make_mesh(8)
    jres = jdba.distributed_bundle_adjust(
        jdba.shard_problem(problem, jmesh), 0.01, 0.02, jmesh, num_steps=8)
    res = dba.distributed_bundle_adjust(
        dba.shard_problem(convert.problem_from_jax(problem), mesh8),
        0.01, 0.02, mesh8, num_steps=8)
    _close(res, jres, pose_atol=5e-4)
    assert int(res.num_inlier_obs) == int(jres.num_inlier_obs)
    assert np.array_equal(res.outliers.numpy(), np.asarray(jres.outliers))


def test_matches_single_device(mesh8, rng):
    problem, _, _ = build_problem(rng, K=6, L=128, M=6, obs_noise=3e-4)
    p = convert.problem_from_jax(problem)
    res1 = bundle_adjust(p, 0.01, 0.02, num_steps=8)
    resN = dba.distributed_bundle_adjust(dba.shard_problem(p, mesh8),
                                         0.01, 0.02, mesh8, num_steps=8)
    _close(resN, res1)


def test_converges_on_mesh(mesh8, rng):
    problem, _, _ = build_problem(rng, K=6, L=128, M=6, pose_noise=0.03)
    res = dba.distributed_bundle_adjust(
        dba.shard_problem(convert.problem_from_jax(problem), mesh8),
        0.01, 0.01, mesh8, num_steps=10)
    assert float(res.mean_sq_error) < 1e-7


def _perturbed64(prob, seed, pose_noise=0.03, point_noise=0.05):
    """``prob`` in float64 with its free poses retracted and its live
    points moved by seeded normal noise."""
    g = np.random.default_rng(seed)
    xi = torch.as_tensor(g.normal(0, pose_noise, (prob.kf_poses.shape[0],
                                                  6)), dtype=torch.float32)
    dx = torch.as_tensor(g.normal(0, point_noise, (prob.points.shape[0],
                                                   3)), dtype=torch.float32)
    p = prob._replace(
        kf_poses=torch.where(prob.kf_fixed[:, None], prob.kf_poses,
                             se3.pose_retract(prob.kf_poses, xi)),
        points=torch.where(prob.point_valid[:, None], prob.points + dx,
                           prob.points))
    return p._replace(**{f: v.double() for f, v in p._asdict().items()
                         if v.dtype == torch.float32})


@pytest.mark.parametrize("case", ["ring_map", "distance_tether"])
def test_float64_matches_single(mesh8, rng, case):
    """On the stored 100-frame ring map, and on a synthetic problem with a
    distance tether, perturbed and in float64: the 8-shard solve equals
    the single-device one to rounding while both move the map by well
    over the float32 tolerances (a shard dropped or a tether counted 8
    times would show)."""
    if case == "ring_map":
        with np.load(FIXTURE) as z:
            m = convert.map_from_npz(z, device="cpu")
            fx = float(z["map_cal"][0])
            s = MageSlamSettings.from_json(str(z["map_settings_json"]))
        prob = global_ba.build_global_problem(m).problem
        hd = float(np.float32(s.bundle_adjust.huber_width / fx))
        moe = float(np.float32(s.graph_optimization.max_outlier_error / fx))
    else:
        problem, poses_gt, _ = build_problem(rng, K=6, L=128, M=6, T=1)
        prob = convert.problem_from_jax(_with_distance_tether(problem,
                                                              poses_gt))
        hd, moe = 0.01, 0.01
    p = _perturbed64(prob, 11)
    res1 = bundle_adjust(p, hd, moe, num_steps=6)
    resN = dba.distributed_bundle_adjust(dba.shard_problem(p, mesh8), hd,
                                         moe, mesh8, num_steps=6)
    assert resN.kf_poses.dtype == torch.float64
    free = ~p.kf_fixed
    assert float((res1.kf_poses - p.kf_poses)[free].abs().max()) > 1e-3
    assert float((res1.points - p.points)[p.point_valid].abs().max()) > 1e-2
    assert float(resN.mean_sq_error) == pytest.approx(
        float(res1.mean_sq_error), rel=1e-9)
    np.testing.assert_allclose(resN.kf_poses.numpy(), res1.kf_poses.numpy(),
                               atol=1e-7)
    np.testing.assert_allclose(resN.points.numpy(), res1.points.numpy(),
                               atol=1e-7)


def test_tethers_counted_once(mesh8, rng):
    """Replicated tethers enter the reduced system once: the 8-shard solve
    equals the single-device one (tolerance of the JAX test)."""
    problem, poses_gt, _ = build_problem(rng, K=6, L=128, M=6, T=1)
    p = convert.problem_from_jax(_with_distance_tether(problem, poses_gt))
    res1 = bundle_adjust(p, 0.01, 0.01, num_steps=8)
    resN = dba.distributed_bundle_adjust(dba.shard_problem(p, mesh8),
                                         0.01, 0.01, mesh8, num_steps=8)
    np.testing.assert_allclose(resN.kf_poses.numpy(), res1.kf_poses.numpy(),
                               atol=5e-4)


def test_shard_problem_blocks(mesh8, rng):
    """Each shard holds its L/8 landmark block, the cameras and no
    tethers; the replicated part holds the cameras and the tethers."""
    problem, _, _ = build_problem(rng, K=6, L=128, M=6, T=1)
    p = convert.problem_from_jax(problem)
    sp = dba.shard_problem(p, mesh8)
    assert len(sp.shards) == 8
    for i, sh in enumerate(sp.shards):
        assert torch.equal(sh.points, p.points[16 * i:16 * (i + 1)])
        assert torch.equal(sh.kf_poses, p.kf_poses)
        assert sh.tether_i.numel() == 0
    assert sp.replicated.points.shape[0] == 0
    assert torch.equal(sp.replicated.tether_weight, p.tether_weight)
    with pytest.raises(ValueError, match="divide"):
        dba.shard_problem(p, dba.make_mesh(devices=["cpu"] * 3))


def _counting(monkeypatch):
    calls = []
    real = global_ba.global_bundle_adjust_distributed

    def wrapped(*a, **k):
        calls.append(a[3].size)
        return real(*a, **k)
    monkeypatch.setattr(global_ba, "global_bundle_adjust_distributed",
                        wrapped)
    return calls


def test_engine_dispatch_matches_single(mesh8, monkeypatch):
    """``engine_global_bundle_adjust`` routes the certification map
    through the distributed solver on the 8-shard mesh and lands where the
    single-device global BA does."""
    m, s_on = certification_map(device="cpu")
    s_off = s_on.replace(parallel=dataclasses.replace(
        s_on.parallel, use_distributed_global_ba=False))
    calls = _counting(monkeypatch)
    m1, r1 = global_ba.engine_global_bundle_adjust(m, s_off, 272.0,
                                                   num_steps=6, lam0=1e-4)
    assert calls == []
    mN, rN = global_ba.engine_global_bundle_adjust(
        m, s_on, 272.0, num_steps=6, lam0=1e-4, mesh=mesh8)
    assert calls == [8]
    assert float(rN.mean_sq_error) == pytest.approx(
        float(r1.mean_sq_error), rel=1e-3, abs=1e-9)
    np.testing.assert_allclose(mN.kf_pose.numpy(), m1.kf_pose.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(mN.mp_pos.numpy(), m1.mp_pos.numpy(),
                               atol=1e-3)


def test_ba_to_floor_passes_the_mesh(mesh8, monkeypatch):
    """``global_ba_to_floor`` (fossilize's) hands its mesh to every
    chunk."""
    m, s_on = certification_map(device="cpu")
    calls = _counting(monkeypatch)
    global_ba.global_ba_to_floor(m, s_on, 272.0, lam0=1e-4, chunk_steps=2,
                                 max_steps=4, mesh=mesh8)
    assert calls == [8, 8]


def test_cpu_map_default_mesh_runs_single(monkeypatch):
    """Without a mesh, a map on the CPU gets one CPU shard: the parallel
    setting then runs single-device (as JAX does on one device), bit for
    bit, and never asks for the card."""
    m, s_on = certification_map(device="cpu")
    s_off = s_on.replace(parallel=dataclasses.replace(
        s_on.parallel, use_distributed_global_ba=False))
    calls = _counting(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ma, _ = global_ba.engine_global_bundle_adjust(m, s_on, 272.0,
                                                  num_steps=3, lam0=1e-4)
    mb, _ = global_ba.engine_global_bundle_adjust(m, s_off, 272.0,
                                                  num_steps=3, lam0=1e-4)
    assert calls == []
    assert torch.equal(ma.kf_pose, mb.kf_pose)
    assert torch.equal(ma.mp_pos, mb.mp_pos)


def test_make_mesh_default_is_the_card(monkeypatch):
    """``make_mesh()`` with no devices takes the visible cards: without a
    card (and no process group) it raises, like every entry point."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dba.make_mesh()
    mesh = dba.make_mesh(3, devices=["cpu"] * 8)
    assert (mesh.size, mesh.first, mesh.group) == (3, 0, None)


def test_mesh_reduce_is_a_left_fold(mesh8):
    """The reduction folds the shards' partials in shard order."""
    parts = [torch.full((3,), 0.1 * (i + 1), dtype=torch.float32)
             for i in range(8)]
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    assert torch.equal(mesh8.reduce(parts), acc)
