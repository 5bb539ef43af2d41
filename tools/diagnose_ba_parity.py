"""Why step parity between the port and the JAX engine ends at a local BA.

Feeds one stored local-BA window to both packages' LM step, step by step,
and prints, for each quantity of the step (the error before and after, the
Schur camera system ``S`` and its right-hand side ``b``, the camera update
``dc``, the point update ``dp``), three distances relative to the quantity's
scale: the port against JAX (``pj``), JAX float32 against the same step in
float64 (``jd``) and the port against that float64 step (``pd``).  Each
step starts both packages from JAX's carry, so a row shows what one step
does to identical inputs; the accept decisions of JAX in float32, the port
and float64 are printed beside the relative gap |err1 - err0| / err0.

Windows (problems stored in ``tests/data/torch_ring150.npz``):

- ``ring_end``: the ``ring_fast`` drive's active window after its last
  frame (5 free keyframes, 425 points), 24 steps (three engine runs of 8);
- ``drift``: the injected-drift map's window (2 free keyframes, 262
  points), 12 steps, which reach the error floor.

It writes ``tests/data/torch_ba_steps.npz``, which
``tests/test_torch_ba_parity.py`` reads: per window and step, JAX's carry
(``<w>_poses``, ``<w>_points``, ``<w>_lam``), and JAX's ``err0``, ``err1``,
``accept``, ``dc``, ``dp`` in float32 and, on the same carry, in float64
(``<w>_x64_*``), with the settings' Huber width (``<w>_huber``); and
``S`` in both precisions at the first step of each engine run
(``<w>_S``, ``<w>_x64_S``, steps ``<w>_S_steps``).

Run from the repository root (about 2 minutes on the CPU):

    JAX_PLATFORMS=cpu python tools/diagnose_ba_parity.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
RING = ROOT / "tests" / "data" / "torch_ring150.npz"
OUT = ROOT / "tests" / "data" / "torch_ba_steps.npz"
# window name -> (state prefix in RING, settings key, LM steps)
WINDOWS = {"ring_end": ("ring_state_end/", "ring_fast_settings_json", 24),
           "drift": ("drift_state/", "drift_settings_json", 12)}
QUANTITIES = ("err0", "err1", "dc", "dp")
S_EVERY = 8            # LM steps per engine run (ba_per_run)


def window_problem(z, prefix: str) -> dict:
    from mageslam_tpu.solvers.bundle_adjust import BAProblem
    return {f: z[f"{prefix}ba_window/problem/{f}"] for f in BAProblem._fields}


def huber_delta(z, settings_key: str) -> np.float32:
    from mageslam_tpu_torch.config import MageSlamSettings
    s = MageSlamSettings.from_json(str(z[settings_key]))
    return np.float32(s.bundle_adjust.huber_width / float(z["cal"][0]))


def jax_stepper(problem: dict, hd, dtype):
    """One LM step of ``bundle_adjust_impl`` as a jitted function of the
    carry, returning its intermediates."""
    import jax
    import jax.numpy as jnp
    from mageslam_tpu.solvers import bundle_adjust as jba
    p = jba.BAProblem(**{k: jnp.asarray(v.astype(dtype) if v.dtype ==
                                        np.float32 else v)
                         for k, v in problem.items()})
    hd = jnp.asarray(hd, dtype)

    @jax.jit
    def step(poses, points, lam):
        err0, _ = jba._error(p, poses, points, hd)
        S, b, V_inv, W, g_p, kf_safe = jba._build_normal_eq(
            p, poses, points, hd, lam)
        dc = jba._solve_schur(S, b, p.kf_fixed, lam)
        dc_pad = jnp.concatenate([dc, jnp.zeros((1, 6), dc.dtype)], 0)
        wtdc = jnp.einsum("lmbc,lmb->lc", W, dc_pad[kf_safe])
        dp = jnp.einsum("lbc,lc->lb", V_inv, g_p - wtdc) \
            * p.point_valid[:, None]
        new_poses = jax.vmap(jba.se3.pose_retract)(poses, dc)
        err1, _ = jba._error(p, new_poses, points + dp, hd)
        return dict(err0=err0, err1=err1, S=S, b=b, dc=dc, dp=dp,
                    poses=new_poses, points=points + dp)
    return step


def port_step(problem: dict, hd, poses, points, lam, dtype):
    import torch
    from mageslam_tpu_torch.geometry import se3
    from mageslam_tpu_torch.solvers import bundle_adjust as tba
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    p = tba.BAProblem(**{k: torch.as_tensor(
        v.astype(dtype) if v.dtype == np.float32 else v)
        for k, v in problem.items()})
    poses, points, lam = (torch.as_tensor(np.asarray(a)).to(tdt)
                          for a in (poses, points, lam))
    err0, _ = tba._error(p, poses, points, float(hd))
    S, b, V_inv, W, g_p, kf_safe = tba._build_normal_eq(
        p, poses, points, float(hd), lam, False)
    dc = tba._solve_schur(S, b, p.kf_fixed, lam)
    dc_pad = torch.cat([dc, dc.new_zeros((1, 6))], 0)
    wtdc = torch.einsum("lmbc,lmb->lc", W, dc_pad[kf_safe])
    dp = torch.einsum("lbc,lc->lb", V_inv, g_p - wtdc) \
        * p.point_valid[:, None]
    err1, _ = tba._error(p, se3.pose_retract(poses, dc), points + dp,
                         float(hd))
    return {k: v.numpy() for k, v in dict(err0=err0, err1=err1, S=S, b=b,
                                           dc=dc, dp=dp).items()}


def run_window(name: str, z, out: dict):
    import jax
    import jax.numpy as jnp
    prefix, settings_key, steps = WINDOWS[name]
    problem = window_problem(z, prefix)
    hd = huber_delta(z, settings_key)
    step = jax_stepper(problem, hd, np.float32)
    poses = jnp.asarray(problem["kf_poses"])
    points = jnp.asarray(problem["points"])
    lam = jnp.float32(z[f"{prefix}lam"])
    rec = {k: [] for k in ("poses", "points", "lam", "accept") + QUANTITIES}
    carries, f32 = [], []
    for _ in range(steps):
        r = step(poses, points, lam)
        accept = bool(r["err1"] < r["err0"])
        carries.append((np.asarray(poses), np.asarray(points),
                        np.asarray(lam)))
        f32.append({k: np.asarray(v) for k, v in r.items()})
        for k, v in zip(("poses", "points", "lam"), carries[-1]):
            rec[k].append(v)
        rec["accept"].append(accept)
        for k in QUANTITIES:
            rec[k].append(np.asarray(r[k]))
        poses = jnp.where(accept, r["poses"], poses)
        points = jnp.where(accept, r["points"], points)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-7, 1e3)
    # the same steps in float64, each on JAX's float32 carry
    jax.config.update("jax_enable_x64", True)
    try:
        step64 = jax_stepper(problem, hd, np.float64)
        x64 = [{k: np.asarray(v) for k, v in step64(
            *(jnp.asarray(a, jnp.float64) for a in c)).items()}
            for c in carries]
    finally:
        jax.config.update("jax_enable_x64", False)
    for k, v in rec.items():
        out[f"{name}_{k}"] = np.stack(v)
    for k in QUANTITIES:
        out[f"{name}_x64_{k}"] = np.stack([r[k] for r in x64])
    out[f"{name}_x64_accept"] = np.array([bool(r["err1"] < r["err0"])
                                          for r in x64])
    out[f"{name}_huber"] = hd
    s_steps = np.arange(0, steps, S_EVERY)
    out[f"{name}_S_steps"] = s_steps
    out[f"{name}_S"] = np.stack([f32[i]["S"] for i in s_steps])
    out[f"{name}_x64_S"] = np.stack([x64[i]["S"] for i in s_steps])

    print(f"\n{name}: {(~problem['kf_fixed']).sum()} free keyframes, "
          f"{problem['point_valid'].sum()} points, "
          f"{problem['obs_valid'].sum()} observations; per step: "
          "accept JAX/port/float64, gap, then pj jd pd per quantity")
    pv = problem["point_valid"]
    for i, (c, a, d) in enumerate(zip(carries, f32, x64)):
        t = port_step(problem, hd, *c, np.float32)
        cols = []
        for k in ("err0", "S", "b", "dc", "dp", "err1"):
            ja, ta, da = (np.asarray(x[k], np.float64) for x in (a, t, d))
            if k == "dp":
                ja, ta, da = ja[pv], ta[pv], da[pv]
            sc = max(np.abs(da).max(), 1e-30)
            cols.append(f"{k} {np.abs(ta - ja).max() / sc:.1e} "
                        f"{np.abs(ja - da).max() / sc:.1e} "
                        f"{np.abs(ta - da).max() / sc:.1e}")
        acc = [bool(x["err1"] < x["err0"]) for x in (a, t, d)]
        gap = abs(float(a["err1"]) - float(a["err0"])) / float(a["err0"])
        print(f"{i:2d} lam {float(c[2]):.3g} accept "
              f"{'/'.join('TF'[not x] for x in acc)} gap {gap:.2e} | "
              + " | ".join(cols), flush=True)


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    torch.set_num_threads(2)
    z = np.load(RING)
    out = {}
    for name in WINDOWS:
        run_window(name, z, out)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
