"""The comparison that decides ``correct``.

After the window has closed, a sample of what the timed path produced,
drawn from the seed, is held against the plain references of
``reference/``, which recompute it from the same inputs:

- ``frontend_mismatch``: feature slots of sampled window frames whose
  validity or BRIEF descriptor (integer bits) differs from the
  reference's, recomputed from the same uint8 frame.  An exact
  comparison: its limit is 0.
- ``frontend_float_gap``: over the slots valid on both sides with the
  same descriptor, the largest gap of a float field: pixel position,
  FAST response and normalized coordinates as ``|p - r| / (|r| + 1)``,
  the intensity-centroid angle as its wrapped difference over pi.
- ``match_mismatch``: over sampled tracked window frames, the entries in
  which tracking's matching differs from the reference's
  (``reference/matching.py``), recomputed from the reference's own
  features of the frame, the candidates' descriptors and the predicted
  pixels the program searched around: the candidate's feature in each
  of the four radius searches, and whether it is matched for each pose
  refinement.  Integer logic on the same inputs: its limit is 0.
- ``match_pixel_gap_px``: over the same frames, the largest distance
  between those predicted pixels and the float64 projections of the
  candidates under the prior pose and the first refinement's pose.
- ``pose_gap_px``: the largest shift, in pixels, of a matched map point's
  projection between the program's tracking pose and the reference's
  float64 refinement from the same matches and starting pose, over
  sampled pose refinements (both stages of tracking) of window frames
  that were tracked.
- ``ba_gap_px``: the largest shift, in pixels, of an observation's
  reprojection between the program's local-BA result (keyframe poses and
  map points) and the reference's float64 LM run over the same window,
  from the same start and lambda, over sampled local-BA calls.
- ``unanswered``: window frames with no result after the flush (limit 0:
  every frame gets an answer).
- ``uninitialized``: 1 if the session had not initialized its map by
  the end of the warm-up (limit 0): the window must time a session past
  initialization.  A frame that is not tracked inside the window is an
  answer, counted in ``failed``.

The pose and BA references follow the program's algorithm from the
program's own inputs: its matches and its windows.  What they check is
the arithmetic of the step; the matches are checked by
``match_mismatch``, the frontend by the first two numbers.  The local
map's candidate set (covisibility, gates, compaction) is the program's
state, which the match check takes as given.

``control`` puts the reference, computed in a lower precision, in the
program's place: ``"bf16"`` (bfloat16; the factorizations of the two
linear solves in float32, as no half-precision LU exists) or ``"tf32"``
(float32 with TF32 matrix products, where the program keeps them off).
Limits are in ``limits.json``.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from slambench.reference import frontend as rfront
from slambench.reference import matching as rmatch
from slambench.reference import solvers as rsolve

HERE = Path(__file__).resolve().parent
SAMPLE = dict(frontend=6, refine=24, ba=8, match=8)
TRACK_SHARE = 1 / 8       # window frames whose matching is kept


def track_sample(seed: int, first: int, end: int) -> frozenset:
    """The frames in [first, end) whose matching the probe keeps, drawn
    from the seed before the window opens."""
    rng = np.random.default_rng([int(seed) & ((1 << 63) - 1), 0x7AC])
    pick = rng.random(end - first) < TRACK_SHARE
    return frozenset(first + int(j) for j in np.flatnonzero(pick))


def limits() -> dict:
    return json.loads((HERE / "limits.json").read_text())


def _sample(items: list, k: int, rng) -> list:
    if len(items) <= k:
        return list(items)
    pick = sorted(rng.choice(len(items), size=k, replace=False).tolist())
    return [items[j] for j in pick]


def frontend_params(spec: dict) -> dict:
    """The frontend's parameters as the configuration states them, and
    the calibration as float32 values (the program holds them so)."""
    from slambench import generator
    s = spec["config"]["settings"]
    fe = s["mono"]["camera"]["features"]
    if int(fe["num_levels"]) != 1 or bool(fe["use_orientation"]):
        raise ValueError("the reference frontend covers one level, "
                         "unrotated BRIEF")
    c = generator.calibration(spec["traffic"])
    f32 = {k: float(np.float32(c[k])) for k in ("fx", "fy", "cx", "cy")}
    return dict(f32, fast_threshold=float(fe["fast_threshold"]),
                gaussian_kernel_size=int(fe["gaussian_kernel_size"]),
                num_cells_x=int(fe["num_cells_x"]),
                num_cells_y=int(fe["num_cells_y"]),
                max_features=int(s["capacity"]["max_features"]))


def frontend_mismatch(prog, ref) -> int:
    """Slots whose validity differs, or that are valid on both sides and
    differ in descriptor."""
    pv, rv = prog.valid, ref["valid"]
    same = torch.all(prog.desc == ref["desc"], -1)
    return int(((pv != rv) | (pv & rv & ~same)).sum())


def frontend_float_gap(prog, ref) -> float:
    """The largest gap of a float field over the slots valid on both
    sides with the same descriptor: position, response and normalized
    coordinates relative to ``|reference| + 1``, the angle wrapped and
    over pi."""
    m = prog.valid & ref["valid"] & torch.all(prog.desc == ref["desc"], -1)
    if not bool(m.any()):
        return 0.0
    f64 = torch.float64

    def rel(a, b):
        a, b = a[m].to(f64), b[m].to(f64)
        return float(((a - b).abs() / (b.abs() + 1.0)).max())

    da = prog.angle[m].to(f64) - ref["angle"][m].to(f64)
    da = torch.remainder(da + math.pi, 2 * math.pi) - math.pi
    return max(rel(prog.uv, ref["uv"]), rel(prog.response, ref["response"]),
               rel(prog.xn_undist, ref["xn"]),
               float(da.abs().max()) / math.pi)


def _features(d: dict) -> SimpleNamespace:
    """A reference result in the shape of the program's features."""
    return SimpleNamespace(valid=d["valid"], uv=d["uv"],
                           response=d["response"], angle=d["angle"],
                           xn_undist=d["xn"], desc=d["desc"])


def _shift_px(pose_a, pose_b, pts, mask, fx: float) -> float:
    xa, za = rsolve.project(pose_a, pts)
    xb, zb = rsolve.project(pose_b, pts)
    m = mask & (za > 0) & (zb > 0)
    if not bool(m.any()):
        return 0.0
    d = torch.linalg.vector_norm(xa - xb, dim=-1)
    return float(fx * d[m].max())


class _Precision:
    """Context of a control: its dtype, and TF32 products on for
    ``"tf32"``."""

    def __init__(self, control):
        self.tf32 = control == "tf32"
        self.dtype = torch.bfloat16 if control == "bf16" else torch.float32

    def __enter__(self):
        self.old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        return self.dtype

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.old


def pose_gap(calls, fx: float, control) -> float:
    worst = 0.0
    for _, a, out in calls:
        f64 = torch.float64
        args = dict(huber_delta=float(a["huber_delta"]),
                    outlier_thresh=float(a["outlier_thresh"]),
                    iters=int(a["iters"]), damping=float(a["damping"]))
        pts = a["points_w"].to(f64)
        ref, _ = rsolve.refine_pose(a["pose0"].to(f64), pts,
                                    a["xn_obs"].to(f64), a["valid"], **args)
        if control:
            with _Precision(control) as dt:
                cand, _ = rsolve.refine_pose(
                    a["pose0"].to(dt), a["points_w"].to(dt),
                    a["xn_obs"].to(dt), a["valid"], **args)
        else:
            cand = out.pose
        worst = max(worst, _shift_px(cand.to(f64), ref, pts, a["valid"], fx))
    return worst


def match_rules(spec: dict) -> dict:
    """Tracking's search radii and match thresholds as the configuration
    states them."""
    s = spec["config"]["settings"]
    pe, tl = s["pose_estimation"], s["track_local_map"]
    return dict(search_radius=float(pe["search_radius"]),
                wider_search_radius=float(pe["wider_search_radius"]),
                extra_wider_search_radius=float(
                    pe["extra_wider_search_radius"]),
                feature_match_threshold=int(pe["feature_match_threshold"]),
                min_tracked_feature_count=int(
                    tl["min_tracked_feature_count"]),
                match_search_radius=float(tl["match_search_radius"]),
                max_distance=int(tl["matcher"]["max_hamming_distance"]),
                min_difference=int(tl["matcher"]["min_hamming_difference"]))


ROUNDS = ("r1", "r2", "r3", "r4")


def match_numbers(rec: dict, feats: dict, cal: dict, rules: dict,
                  control) -> tuple:
    """(mismatch, pixel gap) of one frame's matching.  The mismatch: the
    entries that differ from the reference matching on the same
    predicted pixels (the feature each candidate takes in each of the
    four searches, and whether it is matched for each of the two
    refinements).  The pixel gap: the largest distance, in pixels,
    between the predicted pixels the searches used and the float64
    projections of the candidates under the prior and the first
    refinement's pose."""
    (a1, o1), (a2, _) = rec["refine"][:2]
    _, desc_c, c_valid = rec["queries"][0]
    f64 = torch.float64
    pos = a1["points_w"]
    ref_uv1, _ = rmatch.pixels(a1["pose0"].to(f64), pos.to(f64), cal)
    ref_uv2, z2 = rmatch.pixels(o1.pose.to(f64), pos.to(f64), cal)
    if control:
        with _Precision(control) as dt:
            uv1, _ = rmatch.pixels(a1["pose0"].to(dt), pos.to(dt), cal)
            uv2, _ = rmatch.pixels(o1.pose.to(dt), pos.to(dt), cal)
    else:
        uv1, uv2 = rec["queries"][0][0], rec["queries"][3][0]
    ref = rmatch.track_matches(uv1, uv2, z2, desc_c, c_valid, feats, cal,
                               rules, o1.inliers)
    if control:
        prog = dict({k: ref[k] for k in ROUNDS}, v1=ref["m1"] >= 0,
                    v2=ref["m2"] >= 0)
    else:
        prog = dict(zip(ROUNDS, rec["rounds"][:4]), v1=a1["valid"],
                    v2=a2["valid"])
    n = sum(int((prog[k].long() != ref[k]).sum()) for k in ROUNDS)
    n += int((prog["v1"] != (ref["m1"] >= 0)).sum())
    n += int((prog["v2"] != (ref["m2"] >= 0)).sum())
    gap = torch.cat([
        torch.linalg.vector_norm(uv1.to(f64) - ref_uv1, dim=-1)[c_valid],
        torch.linalg.vector_norm(uv2.to(f64) - ref_uv2, dim=-1)[
            ref["cand2"]]])
    return n, float(gap.max()) if gap.numel() else 0.0


def _problem(p, dtype) -> dict:
    return dict(kf_poses=p.kf_poses.to(dtype), kf_fixed=p.kf_fixed,
                points=p.points.to(dtype), point_valid=p.point_valid,
                obs_kf=p.obs_kf, obs_xn=p.obs_xn.to(dtype),
                obs_valid=p.obs_valid)


def ba_gap(calls, fx: float, control) -> float:
    worst = 0.0
    for _, a, out in calls:
        p = a["problem"]
        if bool((p.tether_type != 0).any()):
            raise ValueError("the reference local BA takes no tethers")
        delta = float(a["huber_delta"])
        steps = int(a["num_steps"])
        lam0 = float(a["lam0"])
        q = _problem(p, torch.float64)
        ref_poses, ref_points, _ = rsolve.local_ba(q, delta, steps, lam0)
        if control:
            with _Precision(control) as dt:
                cand_poses, cand_points, _ = rsolve.local_ba(
                    _problem(p, dt), delta, steps, lam0)
        else:
            cand_poses, cand_points = out.kf_poses, out.points
        cand_poses = cand_poses.to(torch.float64)
        cand_points = cand_points.to(torch.float64)
        kf = p.obs_kf.long()
        xa, za = rsolve.project(cand_poses[kf], cand_points[:, None, :])
        xb, zb = rsolve.project(ref_poses[kf], ref_points[:, None, :])
        m = p.obs_valid & p.point_valid[:, None] & (za > 0) & (zb > 0)
        if bool(m.any()):
            d = torch.linalg.vector_norm(xa - xb, dim=-1)
            worst = max(worst, float(fx * d[m].max()))
    return worst


def run(probe, frames, spec: dict, seed: int, device, control=None,
        extra: dict | None = None, tracked=None) -> dict:
    """{number: {"value", "limit"}} for this run; a number whose sample is
    empty in this run (no local BA in the window) is left out.  Pose
    refinements are sampled from the frames in ``tracked`` (the frames
    whose answer is a pose); a frame that is not tracked answers with no
    pose."""
    rng = np.random.default_rng([int(seed) & ((1 << 63) - 1), 0x5EED])
    lim = limits()
    params = frontend_params(spec)
    fx = params["fx"]
    vals = dict(extra or {})
    with torch.no_grad():
        fr = _sample(probe.frontend, SAMPLE["frontend"], rng)
        if fr:
            n, gap = 0, 0.0
            for i, feats in fr:
                img = torch.as_tensor(frames[i]).to(device)
                ref = rfront.extract(img, params)
                if control:
                    with _Precision(control) as dt:
                        feats = _features(rfront.extract(img, params, dt))
                n += frontend_mismatch(feats, ref)
                gap = max(gap, frontend_float_gap(feats, ref))
            vals["frontend_mismatch"] = n
            vals["frontend_float_gap"] = gap
        rc = _sample([c for c in probe.refine
                      if tracked is None or c[0] in tracked],
                     SAMPLE["refine"], rng)
        if rc:
            vals["pose_gap_px"] = pose_gap(rc, fx, control)
        bc = _sample(probe.ba, SAMPLE["ba"], rng)
        if bc:
            vals["ba_gap_px"] = ba_gap(bc, fx, control)
        tc = _sample([t for t in probe.tracks
                      if tracked is None or t[0] in tracked],
                     SAMPLE["match"], rng)
        if tc:
            cal = dict(params, width=int(spec["traffic"]["width"]),
                       height=int(spec["traffic"]["height"]))
            rules = match_rules(spec)
            n, gap = 0, 0.0
            for i, rec in tc:
                img = torch.as_tensor(frames[i]).to(device)
                dn, dg = match_numbers(rec, rfront.extract(img, params),
                                       cal, rules, control)
                n, gap = n + dn, max(gap, dg)
            vals["match_mismatch"] = n
            vals["match_pixel_gap_px"] = gap
    return {k: dict(value=float(v), limit=lim.get(k))
            for k, v in vals.items()}
