"""Initialization, tracking and mapping parity: the port against JAX.

- ``attempt_initialization`` on a fixture frame pair with the JAX run's
  own RANSAC draws (recomputed here with its key splitting).  The 5-point
  pool's nullspace basis differs between LAPACK builds (see
  test_torch_geometry_solvers.py), so the essential winner may be another
  member of the same consensus: success, match count and model vote
  exact, map size within 5%, pose direction close.  With the JAX run's
  essential result injected, everything downstream (triangulation, gates,
  init BA) is exact in point masks and match indices, pose within 1e-4.
- ``track_frame`` on the two-keyframe fixture of ``__graft_entry__.entry``:
  association, inliers, found mask and reference keyframes exact; pose
  within 1e-4.
- ``create_new_map_points``, ``build_local_window`` +
  ``bundle_adjust_impl``, and the culling functions on a JAX map carried
  across with ``convert.py`` (the fixture's engine state at frame 40):
  integer fields exact, positions within 1e-4.  The same map feeds
  fossilize's global BA (problem exact, solution within 1e-4 of the scene
  scale) and BoW training on its pooled descriptors with the JAX run's
  centroid seeds (tree exact, idf and signatures within 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mageslam_tpu.geometry.camera import CameraCalibration as JaxCal
from mageslam_tpu.mapping import culling as jcull
from mageslam_tpu.mapping import local_ba as jlba
from mageslam_tpu.mapping import new_points as jnp_pts
from mageslam_tpu.ops import matching as jmatch
from mageslam_tpu.solvers import bundle_adjust as jba
from mageslam_tpu.solvers import essential as jess
from mageslam_tpu.tracking import initialization as jinit
from mageslam_tpu.tracking.frontend import extract_features as jextract
from mageslam_tpu_torch import convert
from mageslam_tpu_torch.mapping import culling, local_ba, new_points
from mageslam_tpu_torch.solvers import bundle_adjust as ba
from mageslam_tpu_torch.solvers import essential
from mageslam_tpu_torch.tracking import initialization, track
from test_torch_engine import (fixture_calibration, fixture_settings,
                               jax_state_namespace, load_fixture)

torch.set_num_threads(2)


def _np(x):
    return np.asarray(x)


def _jax_cal(z):
    fx, fy, cx, cy, w, h = z["cal"].tolist()
    return JaxCal.pinhole(fx, fy, cx, cy, int(w), int(h))


def _choice(key, n, k, p, num):
    keys = jax.random.split(key, num)
    return np.array(jax.vmap(lambda kk: jax.random.choice(
        kk, n, shape=(k,), replace=False, p=p))(keys))


@pytest.fixture(scope="module")
def init_case():
    """A fixture frame pair, the JAX result, and the JAX run's own draws
    (recomputed with its key splitting)."""
    z = load_fixture()
    s = fixture_settings("fast")
    si = s.mono.map_init
    jcal = _jax_cal(z)
    F = s.capacity.max_features
    f0, f1 = (jextract(jnp.asarray(z["imgs"][i].astype(np.float32)), jcal,
                       10.0, max_features=F) for i in (0, 3))
    key = jax.random.key(11)
    rj = jinit.attempt_initialization(key, f0, f1, si, float(jcal.fx))
    idx, dist = jmatch.match(f0.desc, f1.desc, f0.valid, f1.valid,
                             si.five_point_matching.max_hamming_distance,
                             si.five_point_matching.min_hamming_difference)
    matched = np.asarray(idx) >= 0
    weight = np.exp(-np.asarray(dist, np.float32) / 12.0)
    p = matched * weight
    p = jnp.asarray((p / max(p.sum(), 1e-9)).astype(np.float32))
    kE, kH = jax.random.split(key)
    draws = initialization.InitDraws(
        e8=torch.as_tensor(_choice(kE, F, 8, p, 1024)).long(),
        e5=torch.as_tensor(_choice(jax.random.fold_in(kE, 5), F, 5, p,
                                   512)).long(),
        h4=torch.as_tensor(_choice(kH, F, 4, p, 512)).long())
    # the essential RANSAC exactly as the JAX initialization runs it
    xn1 = f1.xn_undist[jnp.clip(idx, 0)]
    px = 1.0 / float(jcal.fx)
    ej = jess.essential_ransac(
        kE, f0.xn_undist, xn1, jnp.asarray(matched),
        jnp.float32(si.fundamental_transfer_error_threshold * px),
        jnp.float32(si.min_pixel_spread * px), num_hypotheses=1024,
        sample_weight=jnp.asarray(weight))
    # the port is handed its own settings object with the same values
    si_port = convert.settings_from_jax(s).mono.map_init
    return si_port, float(jcal.fx), f0, f1, rj, draws, ej


def test_attempt_initialization_with_jax_draws(init_case):
    """The whole attempt on the JAX draws.  The 5-point pool's candidates
    differ from JAX's by the LAPACK build's nullspace basis (see
    test_torch_geometry_solvers.py), so the essential winner may be another
    member of the same consensus: success, match count and model vote must
    agree exactly, the map size within 5%, the pose direction closely."""
    si, fx, f0, f1, rj, draws, _ = init_case
    rt = initialization.attempt_initialization(
        draws, convert.features_from_jax(f0), convert.features_from_jax(f1),
        si, fx)
    assert bool(rj.success) and bool(rt.success)
    assert int(rt.num_matches) == int(rj.num_matches)
    assert bool(rt.used_homography) == bool(rj.used_homography)
    nj, nt = int(rj.num_points), int(rt.num_points)
    assert abs(nt - nj) <= 0.05 * nj, (nt, nj)
    vj, vt = _np(rj.point_valid), rt.point_valid.numpy()
    both = vj & vt
    assert both.sum() >= 0.9 * vj.sum()
    np.testing.assert_array_equal(rt.match_idx.numpy()[both],
                                  _np(rj.match_idx)[both])
    tj, tt = _np(rj.pose1)[4:], rt.pose1.numpy()[4:]
    cos = np.dot(tj, tt) / (np.linalg.norm(tj) * np.linalg.norm(tt))
    assert cos > 0.99, cos
    np.testing.assert_allclose(rt.pose1.numpy()[:4], _np(rj.pose1)[:4],
                               atol=5e-3)


def test_attempt_initialization_exact_given_the_essential_result(
        init_case, monkeypatch):
    """Everything after the essential RANSAC, exactly: with the JAX run's
    essential result injected (and the homography RANSAC, which has a
    unique minimal solver, run by the port on the JAX draws), the point
    masks, match indices and map size are exact and the BA'd pose within
    1e-4, the points within 1e-4 of the scene scale."""
    si, fx, f0, f1, rj, draws, ej = init_case
    carried = essential.EssentialResult(
        *(torch.as_tensor(np.array(x)) for x in ej))
    monkeypatch.setattr(initialization.essential,
                        "essential_ransac_from_samples",
                        lambda *a, **k: carried)
    rt = initialization.attempt_initialization(
        draws, convert.features_from_jax(f0), convert.features_from_jax(f1),
        si, fx)
    assert bool(rt.success) == bool(rj.success)
    assert bool(rt.used_homography) == bool(rj.used_homography)
    np.testing.assert_array_equal(rt.point_valid.numpy(),
                                  _np(rj.point_valid))
    np.testing.assert_array_equal(rt.match_idx.numpy(), _np(rj.match_idx))
    assert int(rt.num_points) == int(rj.num_points)
    np.testing.assert_allclose(rt.pose1.numpy(), _np(rj.pose1), atol=1e-4)
    # points within 1e-4 relative to the scene scale (the baseline is 1)
    v = _np(rj.point_valid)
    scale = float(np.linalg.norm(_np(rj.points)[v], axis=-1).mean())
    np.testing.assert_allclose(rt.points.numpy()[v] / scale,
                               _np(rj.points)[v] / scale, atol=1e-4)


def test_track_frame_on_entry_fixture():
    import __graft_entry__ as ge
    fn, (m, feats, prior) = ge.entry()
    rj = fn(m, feats, prior)
    s = ge._tiny_settings()
    from mageslam_tpu.io.synthetic import default_calibration
    cal = convert.calibration_from_jax(default_calibration())
    rt = track.track_frame(convert.map_from_jax(m),
                           convert.features_from_jax(feats),
                           torch.as_tensor(_np(prior)), 1, cal,
                           convert.settings_from_jax(s),
                           max_local_kf=4)
    np.testing.assert_array_equal(rt.assoc.numpy(), _np(rj.assoc))
    np.testing.assert_array_equal(rt.found_mp_mask.numpy(),
                                  _np(rj.found_mp_mask))
    np.testing.assert_array_equal(rt.local_mp_mask.numpy(),
                                  _np(rj.local_mp_mask))
    assert int(rt.num_inliers) == int(rj.num_inliers) > 30
    assert int(rt.ref_kf) == int(rj.ref_kf)
    np.testing.assert_array_equal(rt.anchor_kf.numpy(), _np(rj.anchor_kf))
    np.testing.assert_allclose(rt.pose.numpy(), _np(rj.pose), atol=1e-4)


def _map40():
    z = load_fixture()
    ns = jax_state_namespace(z, "fast_state40/")
    return z, ns


def _jmap(ns):
    from mageslam_tpu.mapstore.map_state import MapState
    return MapState(**{f: jnp.asarray(getattr(ns.map, f))
                       for f in MapState._fields})


def _assert_maps_equal(mt, mj, pos_atol=1e-4):
    got = convert.to_numpy(mt)
    for name in got:
        want = _np(getattr(mj, name))
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got[name], want, atol=pos_atol,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], want, err_msg=name)


def test_new_points_and_culling_on_carried_map():
    z, ns = _map40()
    s = fixture_settings("fast")
    mj = _jmap(ns)
    mt = convert.map_from_jax(ns.map)
    new_kf = int(ns.last_kf)
    jcal = _jax_cal(z)
    cal = fixture_calibration(z)
    fx = float(jcal.fx)
    rj = jnp_pts.create_new_map_points(mj, new_kf, jcal,
                                       s.mapping.new_map_points, fx,
                                       num_candidates=5, scale_factor=1.5)
    rt = new_points.create_new_map_points(mt, new_kf, cal,
                                          convert.settings_from_jax(s)
                                          .mapping.new_map_points, fx,
                                          num_candidates=5,
                                          scale_factor=1.5)
    _assert_maps_equal(rt.map, rj.map)
    assert int(rt.num_created) == int(rj.num_created)
    pct = float(np.float32(s.track_local_map.recent_map_point_pct_success))
    mj2, nj = jcull.cull_recent_map_points(rj.map, jnp.float32(pct),
                                           jnp.int32(3))
    mt2, nt = culling.cull_recent_map_points(rt.map, pct, 3)
    assert int(nt) == int(nj)
    _assert_maps_equal(mt2, mj2)
    cj = jcull.cull_keyframes(mj2, new_kf, jnp.float32(0.9), jnp.int32(3))
    ct = culling.cull_keyframes(mt2, new_kf, float(np.float32(0.9)), 3)
    np.testing.assert_array_equal(ct.kf_culled_mask.numpy(),
                                  _np(cj.kf_culled_mask))
    _assert_maps_equal(ct.map, cj.map)


def test_local_window_and_bundle_adjust_on_carried_map():
    z, ns = _map40()
    s = fixture_settings("fast")
    mj = _jmap(ns)
    mt = convert.map_from_jax(ns.map)
    center = int(ns.last_kf)
    cap = s.capacity
    wj = jlba.build_local_window(mj, center, jnp.int32(15),
                                 window_size=cap.local_ba_keyframes,
                                 num_fixed=8, max_points=cap.local_ba_points)
    wt = local_ba.build_local_window(mt, center, 15,
                                     window_size=cap.local_ba_keyframes,
                                     num_fixed=8,
                                     max_points=cap.local_ba_points)
    for name in ("kf_list", "kf_list_valid", "kf_adjustable", "mp_list",
                 "mp_list_valid"):
        np.testing.assert_array_equal(getattr(wt, name).numpy(),
                                      _np(getattr(wj, name)), err_msg=name)
    for name in ("kf_fixed", "point_valid", "obs_kf", "obs_valid"):
        np.testing.assert_array_equal(getattr(wt.problem, name).numpy(),
                                      _np(getattr(wj.problem, name)))
    np.testing.assert_array_equal(wt.problem.obs_xn.numpy(),
                                  _np(wj.problem.obs_xn))
    px = 1.0 / float(_jax_cal(z).fx)
    hd = float(np.float32(s.bundle_adjust.huber_width * px))
    moe = float(np.float32(s.bundle_adjust.max_outlier_error * px))
    rj = jba.bundle_adjust(wj.problem, jnp.float32(hd), jnp.float32(moe),
                           num_steps=8, lam0=jnp.float32(1e-3))
    rt = ba.bundle_adjust_impl(wt.problem, hd, moe, num_steps=8, lam0=1e-3)
    np.testing.assert_allclose(rt.kf_poses.numpy(), _np(rj.kf_poses),
                               atol=1e-4)
    np.testing.assert_allclose(rt.points.numpy(), _np(rj.points), atol=1e-4)
    np.testing.assert_array_equal(rt.outliers.numpy(), _np(rj.outliers))
    mj2 = jlba.apply_window_result(mj, wj, rj)
    mt2 = local_ba.apply_window_result(mt, wt, rt)
    _assert_maps_equal(mt2, mj2)
    _assert_maps_equal(local_ba.unassociate_outliers(mt2, wt, rt),
                       jlba.unassociate_outliers(mj2, wj, rj))


def test_vocabulary_with_jax_draws():
    """BoW training on the fixture's pooled training descriptors with the
    JAX run's own centroid seeds: tree and quantization exact, idf and
    keyframe signatures within 1e-6."""
    from mageslam_tpu.bow import vocab as jvocab
    from mageslam_tpu_torch.bow import vocab
    _, ns = _map40()
    desc_np, valid_np = ns.train_desc, ns.train_valid
    assert valid_np.sum() > 1000
    desc, valid = jnp.asarray(desc_np), jnp.asarray(valid_np)
    n = desc_np.shape[0]
    key = jax.random.key(5)
    vj = jvocab.train_vocabulary(key, desc, valid, iters=12)
    k1, k2 = jax.random.split(key)
    p = valid_np.astype(np.float32) / max(valid_np.sum(), 1)
    rows = [np.asarray(jax.random.choice(k1, n, (vocab.BRANCH,),
                                         replace=False, p=jnp.asarray(p)))]
    _, assign1 = jvocab._k_majority(k1, desc, valid, vocab.BRANCH, 12)
    for c, kc in enumerate(jax.random.split(k2, vocab.BRANCH)):
        mask = (valid_np & (np.asarray(assign1) == c)).astype(np.float32)
        pc = jnp.asarray(mask / max(mask.sum(), 1.0))
        rows.append(np.asarray(jax.random.choice(kc, n, (vocab.BRANCH,),
                                                 replace=False, p=pc)))
    vt = vocab.train_vocabulary_from_samples(
        convert.tensor_from_numpy(desc_np), torch.as_tensor(valid_np),
        torch.as_tensor(np.stack(rows)).long(), iters=12)
    got = convert.to_numpy(vt)
    np.testing.assert_array_equal(got["l1_desc"], _np(vj.l1_desc))
    np.testing.assert_array_equal(got["leaf_desc"], _np(vj.leaf_desc))
    np.testing.assert_allclose(got["idf"], _np(vj.idf), atol=1e-6)
    kf_desc = ns.map.kf_desc[0]
    np.testing.assert_array_equal(
        vocab.quantize(vt, convert.tensor_from_numpy(kf_desc)).numpy(),
        _np(jvocab.quantize(vj, jnp.asarray(kf_desc))))
    sig_t = vocab.signatures(vt, convert.tensor_from_numpy(ns.map.kf_desc),
                             torch.as_tensor(ns.map.kf_feat_valid))
    for k in range(3):
        np.testing.assert_allclose(
            sig_t[k].numpy(),
            _np(jvocab.signature(vj, jnp.asarray(ns.map.kf_desc[k]),
                                 jnp.asarray(ns.map.kf_feat_valid[k]))),
            atol=1e-6)


def test_global_bundle_adjust_on_carried_map():
    """fossilize's global BA on the frame-40 map: the problem exact, the
    solved map within 1e-4 relative to the scene scale."""
    from mageslam_tpu.mapping import global_ba as jgba
    from mageslam_tpu_torch.mapping import global_ba
    z, ns = _map40()
    mj = _jmap(ns)
    mt = convert.map_from_jax(ns.map)
    wj = jgba.build_global_problem(mj, 12)
    wt = global_ba.build_global_problem(mt, 12)
    for name in ("kf_fixed", "point_valid", "obs_kf", "obs_valid"):
        np.testing.assert_array_equal(getattr(wt.problem, name).numpy(),
                                      _np(getattr(wj.problem, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(wt.problem.obs_xn.numpy(),
                                  _np(wj.problem.obs_xn))
    px = 1.0 / float(_jax_cal(z).fx)
    hd, moe = float(np.float32(2.0 * px)), float(np.float32(8.0 * px))
    m2j, rj = jgba.global_bundle_adjust(mj, jnp.float32(hd),
                                        jnp.float32(moe), num_steps=5,
                                        lam0=jnp.float32(1e-4))
    m2t, rt = global_ba.global_bundle_adjust(mt, hd, moe, num_steps=5,
                                             lam0=1e-4)
    v = ns.map.mp_valid
    scale = float(np.linalg.norm(ns.map.mp_pos[v], axis=-1).mean())
    np.testing.assert_allclose(m2t.kf_pose.numpy(), _np(m2j.kf_pose),
                               atol=1e-4)
    np.testing.assert_allclose(m2t.mp_pos.numpy()[v] / scale,
                               _np(m2j.mp_pos)[v] / scale, atol=1e-4)
    np.testing.assert_array_equal(rt.outliers.numpy(), _np(rj.outliers))
