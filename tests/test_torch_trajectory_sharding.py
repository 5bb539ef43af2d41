"""The port's trajectory sharding
(``mageslam_tpu_torch/parallel/trajectory_sharding``) against the JAX
package's: plans' integer outputs exactly, on synthetic trajectories (JAX
run live) and on the JAX engine's 100-frame ring map stored in
``tests/data/torch_parallel.npz``; the sharded solve against JAX's stored
result within the tolerances that the fixture tool states
(``tools/make_torch_parallel_fixture.py``, ``tol/ts_*``).

The seam-tether case is held against JAX's stored plan, not as an absolute
gate: the JAX package's own version of it fails (a reference defect,
noted at the port site in ``plan_from_map``)."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from mageslam_tpu.parallel import trajectory_sharding as jts
from mageslam_tpu_torch import MageSlamSettings, convert
from mageslam_tpu_torch.mapping import global_ba
from mageslam_tpu_torch.parallel import trajectory_sharding as ts
from mageslam_tpu_torch.parallel.distributed_ba import make_mesh
from mageslam_tpu_torch.solvers.bundle_adjust import bundle_adjust
from tests.test_trajectory_sharding import trajectory_problem

torch.set_num_threads(2)
FIXTURE = Path(__file__).parent / "data" / "torch_parallel.npz"


@pytest.fixture(scope="module")
def z():
    with np.load(FIXTURE) as f:
        yield f


@pytest.fixture(scope="module")
def corridor32():
    """A 32-keyframe corridor of 256 landmarks (the JAX tests'
    ``trajectory_problem``; it projects point by point, so it is
    built once)."""
    return trajectory_problem(np.random.default_rng(42), K=32,
                              per_kf=8)[0]


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def ring(z):
    m = convert.map_from_npz(z)
    s = MageSlamSettings.from_json(str(z["map_settings_json"]))
    return m, s, float(z["map_cal"][0])


def _assert_plan_equal(plan, jplan_fields: dict, label: str):
    for f in ("land_perm", "block_start", "n_dropped_obs",
              "n_dropped_points"):
        assert np.array_equal(getattr(plan, f).numpy(),
                              np.asarray(jplan_fields[f])), (label, f)
    for f in plan.problem._fields:
        got = getattr(plan.problem, f).numpy()
        want = np.asarray(jplan_fields["problem"][f])
        if want.dtype == np.uint32:
            want = want.view(np.int32)
        assert np.array_equal(got, want), (label, f)


@pytest.mark.parametrize("halo", [8, 2, 1])
def test_plan_matches_jax(corridor32, halo):
    """Landmark permutation, window starts, window-local observations and
    the dropped counts equal JAX's, bit for bit (halo 8 drops nothing;
    halos 2 and 1 drop observations)."""
    problem = corridor32
    jplan = jts.plan_trajectory_shards(problem, 8, halo)
    plan = ts.plan_trajectory_shards(convert.problem_from_jax(problem), 8,
                                     halo)
    fields = {f: getattr(jplan, f) for f in jplan._fields}
    fields["problem"] = {f: getattr(jplan.problem, f)
                         for f in jplan.problem._fields}
    _assert_plan_equal(plan, fields, f"halo {halo}")
    assert (int(plan.n_dropped_obs) == 0) == (halo == 8)


@pytest.mark.parametrize("halo", [2, 1])
def test_plan_from_map_matches_jax(z, ring, halo):
    """``plan_from_map`` on the JAX engine's ring map: temporal
    permutation, plan and long-range tethers equal JAX's stored ones
    (halo 2 at min covisibility 100000, halo 1 at 1)."""
    m, _, _ = ring
    kw = {2: dict(min_covis=100000), 1: dict(min_covis=1)}[halo]
    plan, tethers, perm = ts.plan_from_map(m, 8, halo=halo, **kw)
    p = f"plan{halo}_"
    fields = {f: z[p + f] for f in ("land_perm", "block_start",
                                    "n_dropped_obs", "n_dropped_points")}
    fields["problem"] = {f: z[f"{p}problem/{f}"]
                         for f in plan.problem._fields}
    _assert_plan_equal(plan, fields, f"map halo {halo}")
    assert np.array_equal(perm.numpy(), z[p + "perm"])
    for f in tethers._fields:
        got, want = getattr(tethers, f).numpy(), z[f"{p}tethers/{f}"]
        if f == "pose":     # relative poses, float: not an index
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:
            assert np.array_equal(got, want), f
    # the temporal order: frame ids non-decreasing over live slots
    fid = m.kf_frame_id.numpy()[perm.numpy()]
    v = m.kf_valid.numpy()[perm.numpy()]
    assert (np.diff(fid[v]) >= 0).all()


def test_seam_tethers_as_jax(z, ring):
    """The ring's narrow-window plan drops observations and, as in the
    JAX package (whose absolute version of this check fails: the seam
    heuristic ``j - i >= W``), makes the same tethers: none here."""
    m, _, _ = ring
    plan, tethers, _ = ts.plan_from_map(m, 8, halo=1, min_covis=1)
    assert int(plan.n_dropped_obs) == int(z["plan1_n_dropped_obs"]) > 0
    assert int(tethers.n_pairs) == int(z["plan1_tethers/n_pairs"])
    w = tethers.weight.numpy()
    assert (w[tethers.ttype.numpy() > 0] > 0).all()


def test_plan_preserves_observations(corridor32):
    plan = ts.plan_trajectory_shards(convert.problem_from_jax(corridor32),
                                     8, halo=8)
    assert int(plan.n_dropped_obs) == 0
    assert int(plan.n_dropped_points) == 0
    perm = plan.land_perm.numpy()
    live = perm[perm >= 0]
    assert len(np.unique(live)) == len(live)
    assert int(plan.problem.point_valid.sum()) == len(live)


def test_long_range_obs_dropped_and_counted(corridor32):
    p = convert.problem_from_jax(corridor32)
    obs_kf = p.obs_kf.clone()
    obs_kf[0, -1] = 31
    plan = ts.plan_trajectory_shards(p._replace(obs_kf=obs_kf), 8, halo=4)
    base = ts.plan_trajectory_shards(p, 8, halo=4)
    assert int(plan.n_dropped_obs) == int(base.n_dropped_obs) + 1


def test_block_ba_matches_single_device(mesh8, corridor32):
    """The sharded solve against the port's single-device solver on the
    corridor, at the JAX test's tolerances (its note: the chain's
    near-gauge modes amplify float32 summation order to ~1e-2 in pose
    space)."""
    p = convert.problem_from_jax(corridor32)
    res1 = bundle_adjust(p, 0.01, 0.02, num_steps=6)
    plan = ts.plan_trajectory_shards(p, 8, halo=8)
    resN = ts.trajectory_block_bundle_adjust(plan, 0.01, 0.02, mesh8,
                                             halo=8, num_steps=6)
    assert float(resN.mean_sq_error) == pytest.approx(
        float(res1.mean_sq_error), rel=1e-2, abs=1e-9)
    np.testing.assert_allclose(resN.kf_poses.numpy(),
                               res1.kf_poses.numpy(), atol=2e-2)
    perm = plan.land_perm.numpy()
    live = perm >= 0
    d = np.linalg.norm(resN.points.numpy()[live]
                       - res1.points.numpy()[perm[live]], axis=1)
    assert np.quantile(d, 0.95) < 5e-2
    assert d.max() < 0.3


def _assert_near_jax(z, m2, mse, prefix: str):
    v = z["map/kf_valid"]
    mv = z["map/mp_valid"]
    np.testing.assert_allclose(m2.kf_pose.numpy()[v],
                               z[f"{prefix}_kf_pose"][v],
                               atol=float(z["tol/ts_poses"]))
    np.testing.assert_allclose(m2.mp_pos.numpy()[mv],
                               z[f"{prefix}_mp_pos"][mv],
                               atol=float(z["tol/ts_points"]))
    assert float(mse) == pytest.approx(float(z[f"{prefix}_mse"]),
                                       rel=float(z["tol/ts_mse_rel"]))


def test_sharded_ba_on_real_map(z, ring, mesh8):
    """``trajectory_sharded_global_ba`` on the ring map (halo 2, 32
    tethers, min covisibility 5, 6 steps): JAX's stored result within the
    fixture's tolerances, and within 3x the single-device MSE as the JAX
    test bounds it."""
    m, s, fx = ring
    s2 = s.replace(parallel=dataclasses.replace(
        s.parallel, trajectory_halo=2, trajectory_max_tethers=32,
        trajectory_tether_min_covis=5))
    m2, res, info = ts.trajectory_sharded_global_ba(m, s2, fx, mesh8,
                                                    num_steps=6)
    assert [info[k] for k in ("n_dropped_obs", "n_dropped_points",
                              "n_tethers", "n_shards")] \
        == z["ts_info"].tolist()
    _assert_near_jax(z, m2, res.mean_sq_error, "ts")
    assert int(res.num_inlier_obs) == int(z["ts_num_inlier_obs"])
    assert float(res.mean_sq_error) <= 3.0 * float(z["single_mse"]) + 1e-9


def test_engine_dispatch_routes_trajectory(z, ring, mesh8, monkeypatch):
    """With trajectory sharding on and 8 shards, the engine's global-BA
    dispatch takes the trajectory route (a BAResult over all K slots in
    temporal order) and lands on JAX's stored dispatch result."""
    m, s, fx = ring
    s2 = s.replace(parallel=dataclasses.replace(
        s.parallel, use_trajectory_sharding=True,
        trajectory_min_keyframes=4, trajectory_halo=2,
        trajectory_tether_min_covis=5))
    calls = []
    real = ts.trajectory_sharded_global_ba

    def wrapped(*a, **k):
        calls.append(a[3].size)
        return real(*a, **k)
    monkeypatch.setattr(ts, "trajectory_sharded_global_ba", wrapped)
    m2, res = global_ba.engine_global_bundle_adjust(m, s2, fx, num_steps=4,
                                                    lam0=1e-4, mesh=mesh8)
    assert calls == [8]
    assert res.kf_poses.shape[0] == m.kf_valid.shape[0]
    _assert_near_jax(z, m2, res.mean_sq_error, "disp")
    # below trajectory_min_keyframes the dispatch runs single-device
    s3 = s2.replace(parallel=dataclasses.replace(
        s2.parallel, trajectory_min_keyframes=1000))
    global_ba.engine_global_bundle_adjust(m, s3, fx, num_steps=1,
                                          lam0=1e-4, mesh=mesh8)
    assert calls == [8]
