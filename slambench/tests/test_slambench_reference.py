"""The plain references at a tiny size on the CPU: the frontend against
the program's CPU frontend (exact), the two solvers against the
program's in float64, and the references' independence from the
program."""

import ast
import math
from pathlib import Path

import pytest
import torch

from slambench import check, generator, harness
from slambench.reference import frontend as rfront
from slambench.reference import matching as rmatch
from slambench.reference import solvers as rsolve

HERE = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("path", sorted(
    [*(HERE / "reference").glob("*.py"), HERE / "check.py",
     HERE / "generator.py", HERE / "roofline.py"]), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"mageslam_tpu_torch", "mageslam_tpu", "jax"}


@pytest.mark.parametrize("cell", ["console320-explore", "console320-look"])
def test_frontend_equals_program_on_cpu(cell):
    from mageslam_tpu_torch import MageSlamSettings
    from mageslam_tpu_torch.geometry.camera import CameraCalibration
    from mageslam_tpu_torch.tracking.frontend import extract_features
    import json
    spec = harness.cell_spec(harness.manifest(), cell)
    frame = generator.render(spec["traffic"], 5, 2, "cpu")[1]
    params = check.frontend_params(spec)
    s = MageSlamSettings.from_json(json.dumps(spec["config"]["settings"]))
    fe = s.mono.camera.features
    cal = CameraCalibration.pinhole(params["fx"], params["fy"],
                                    params["cx"], params["cy"], 320, 180)
    prog = extract_features(frame.to(torch.float32), cal,
                            float(fe.fast_threshold),
                            max_features=s.capacity.max_features,
                            cells_x=fe.num_cells_x, cells_y=fe.num_cells_y)
    ref = rfront.extract(frame, params)
    assert int(prog.valid.sum()) > 100
    assert check.frontend_mismatch(prog, ref) == 0
    assert check.frontend_float_gap(prog, ref) == 0.0
    bad = prog._replace(desc=prog.desc ^ 1)
    assert check.frontend_mismatch(bad, ref) == int(prog.valid.sum())
    assert check.frontend_float_gap(bad, ref) == 0.0
    shifted = prog._replace(response=prog.response * (1 + 1e-3))
    assert check.frontend_mismatch(shifted, ref) == 0
    assert 5e-4 < check.frontend_float_gap(shifted, ref) < 1e-3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matching_equals_program(seed):
    """Radius search and unique assignment against the program's, with
    repeated descriptors so that ties and shared features occur."""
    from mageslam_tpu_torch.ops import matching
    g = torch.Generator().manual_seed(seed)
    words = torch.randint(-2 ** 31, 2 ** 31 - 1, (12, 8), generator=g,
                          dtype=torch.int64).to(torch.int32)
    q_desc = words[torch.randint(0, 12, (80,), generator=g)]
    t_desc = words[torch.randint(0, 12, (60,), generator=g)]
    flip = torch.randint(0, 2, t_desc.shape, generator=g,
                         dtype=torch.int32) << torch.randint(
        0, 31, t_desc.shape, generator=g, dtype=torch.int32)
    t_desc = t_desc ^ flip
    q_uv = torch.rand(80, 2, generator=g) * 60
    t_uv = torch.rand(60, 2, generator=g) * 60
    q_valid = torch.rand(80, generator=g) > 0.1
    t_valid = torch.rand(60, generator=g) > 0.1
    for radius in (6.0, 12.0, 30.0):
        pi, pd = matching.radius_match(q_uv, q_desc, q_valid, t_uv, t_desc,
                                       t_valid, radius=radius,
                                       max_distance=50, min_difference=1)
        ri, rd = rmatch.radius_match(q_uv, q_desc, q_valid, t_uv, t_desc,
                                     t_valid, radius, 50, 1)
        assert torch.equal(pi.long(), ri)
        assert int((ri >= 0).sum()) > 5
        assert torch.equal(matching.assign_unique(pi, pd).long(),
                           rmatch.assign_unique(ri, rd))


def _random_pose(g, scale=0.05):
    q = torch.cat([torch.ones(1, dtype=torch.float64),
                   scale * torch.randn(3, generator=g, dtype=torch.float64)])
    q = q / q.norm()
    return torch.cat([q, scale * torch.randn(3, generator=g,
                                             dtype=torch.float64)])


def test_refine_pose_equals_program_in_float64():
    from mageslam_tpu_torch.solvers import pnp
    g = torch.Generator().manual_seed(3)
    pts = torch.randn(60, 3, generator=g, dtype=torch.float64) \
        + torch.tensor([0.0, 0.0, 6.0], dtype=torch.float64)
    truth = _random_pose(g)
    xn, _ = rsolve.project(truth[None], pts)
    xn = xn + 1e-3 * torch.randn(xn.shape, generator=g, dtype=torch.float64)
    valid = torch.rand(60, generator=g) > 0.1
    pose0 = rsolve.pose_retract(truth, 0.02 * torch.ones(6,
                                                         dtype=torch.float64))
    kw = dict(huber_delta=0.9 / 272, outlier_thresh=4.5 / 272, iters=6)
    mine, inl = rsolve.refine_pose(pose0, pts, xn, valid, **kw)
    theirs = pnp.refine_pose(pose0, pts, xn, valid, **kw)
    assert torch.allclose(mine, theirs.pose, atol=1e-12)
    assert torch.equal(inl, theirs.inliers)
    assert check._shift_px(mine, truth, pts, valid, 272.0) < 1.0


def test_local_ba_equals_program_in_float64():
    from mageslam_tpu_torch.solvers import bundle_adjust as ba
    g = torch.Generator().manual_seed(4)
    K, L = 5, 40
    poses = torch.stack([_random_pose(g, 0.1) for _ in range(K)])
    pts = torch.randn(L, 3, generator=g, dtype=torch.float64) \
        + torch.tensor([0.0, 0.0, 6.0], dtype=torch.float64)
    obs_kf = torch.arange(K, dtype=torch.int32).expand(L, K).contiguous()
    xn, _ = rsolve.project(poses[obs_kf.long()], pts[:, None, :])
    xn = xn + 2e-3 * torch.randn(xn.shape, generator=g, dtype=torch.float64)
    valid = torch.rand(L, K, generator=g) > 0.2
    fixed = torch.tensor([True, True, False, False, False])
    start = poses.clone()
    start[2:] = rsolve.pose_retract(poses[2:], torch.full(
        (3, 6), 0.01, dtype=torch.float64))
    prob = ba.BAProblem(kf_poses=start, kf_fixed=fixed, points=pts + 0.02,
                        point_valid=torch.ones(L, dtype=torch.bool),
                        obs_kf=obs_kf, obs_xn=xn, obs_valid=valid,
                        **ba.empty_tethers(1))
    res = ba.bundle_adjust_impl(prob, 1.8 / 272, 7.25 / 272, num_steps=4,
                                lam0=1e-4, pose_tethers=False)
    q = check._problem(prob, torch.float64)
    p2, x2, lam = rsolve.local_ba(q, 1.8 / 272, 4, 1e-4)
    assert torch.allclose(p2, res.kf_poses, atol=1e-9)
    assert torch.allclose(x2, res.points, atol=1e-9)
    assert math.isclose(float(lam), float(res.lam), rel_tol=1e-6)
