#!/usr/bin/env python3
"""How the long session's outcome depends on its initial map, on one GPU.

    python3 tools/probe_torch_long_init.py [--cpu]

``tests/test_long_session.py``'s 640-frame slow double loop (40 keyframe
slots; goldens ``tests/data/torch_long640.npz``), driven by
``MageSlamTorchFused`` three ways: resumed from the JAX engine's state
after its initialization (frame 3, ``init_post/``), as ``chip_smoke.py``'s
drive (b), and from the port's own initialization at seeds 1 and 2.  For
each drive it prints the tracked count, the first frame not tracked after
the initialization, keyframes ever and alive, loops closed, the frames of
keyframe decisions before frame 130 beside the JAX drive's, the inliers on
frames 78-86 (the stretch where a 10-frame keyframe cadence meets the
15-inlier floor), seconds and host syncs per frame.  First it prints the
initialization attempt's homography vote on this device: the two of the
eight Faugeras candidates with the most points in front of both cameras,
their reprojection sums, their float32 votes (count - 1e-3 x sum) and the
candidate the engine chose.  It writes the port's own state after its
initialization at seed 1 (every leaf, under its slash-joined field path)
to ``_probe/long_own_init.npz`` (git-ignored), which
``tools/make_torch_long_fixture.py card_init`` reads.

Without a CUDA device the script exits with code 2 unless ``--cpu`` is
given (then the drives run on the CPU with 4 threads, about 5 minutes
each; the thread count changes the float path, and with it this drive's
outcome).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
OWN_INIT = ROOT / "_probe" / "long_own_init.npz"
SEEDS = (1, 2)
CPU_THREADS = 4


def leaves(tree: dict, prefix: str = "") -> dict:
    """``convert.to_numpy``'s nested dict as {slash-joined path: array}."""
    out = {}
    for name, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{name}/"))
        elif v is not None:
            out[prefix + name] = v
    return out


def init_vote(eng, imgs, at: int) -> None:
    """Frames 0 to ``at`` through ``eng``, and its initialization
    attempt's homography vote, candidate by candidate."""
    import torch
    from mageslam_tpu_torch.geometry import se3, triangulation
    from mageslam_tpu_torch.solvers import homography
    from mageslam_tpu_torch.tracking import initialization as init
    calls = []
    sample = init.sample_init_draws

    def recorded(gen, f0, f1, s):
        calls.append((sample(gen, f0, f1, s), f0, f1, s))
        return calls[-1][0]
    init.sample_init_draws = recorded
    try:
        for i in range(at + 1):
            eng.process_frame(imgs[i], timestamp=i / 30.0)
        eng.flush()
    finally:
        init.sample_init_draws = sample
    draws, f0, f1, s = calls[-1]
    px = 1.0 / eng.cal.fx
    idx, _ = init._match(f0, f1, s)
    xn0 = f0.xn_undist
    xn1 = f1.xn_undist[torch.clamp(idx, min=0).long()]
    f32 = torch.float32
    h = homography.homography_ransac_from_samples(
        xn0, xn1, idx >= 0,
        float(torch.tensor(s.fundamental_transfer_error_threshold * px,
                           dtype=f32)),
        float(torch.tensor(s.min_pixel_spread * px, dtype=f32)), draws.h4)
    cands = homography.decompose_homography(h.H)
    r0 = torch.cat([xn0, torch.ones_like(xn0[..., :1])], -1)
    r1 = torch.cat([xn1, torch.ones_like(xn1[..., :1])], -1)
    X, ok = triangulation.triangulate_midpoint(se3.pose_identity(h.H.device),
                                               cands[:, None], r0, r1)
    y1 = se3.pose_apply(cands[:, None], X)
    good = h.inliers & ok & (X[..., 2] > 0) & (y1[..., 2] > 0)
    rr = torch.sum((y1[..., :2] / y1[..., 2:] - xn1) ** 2, -1)
    rsum = torch.where(good, rr, torch.zeros_like(rr)).sum(-1)
    votes = good.sum(-1).to(f32) - 1e-3 * rsum
    chosen = eng.state.map.kf_pose[1]
    norm = torch.linalg.vector_norm
    gap = norm(cands[:, 4:] - chosen[4:], dim=-1) + torch.minimum(
        norm(cands[:, :4] - chosen[:4], dim=-1),
        norm(cands[:, :4] + chosen[:4], dim=-1))
    pick = int(gap.argmin())
    top = torch.argsort(good.sum(-1), descending=True, stable=True)[:2]
    rows = [f"candidate {int(c)}: {int(good[c].sum())} points, "
            f"reprojection sum {float(rsum[c]):.6g}, vote "
            f"{float(votes[c]):.9g}, translation "
            f"{cands[c, 4:].cpu().numpy().round(3).tolist()}"
            for c in top.tolist()]
    print(f"[init vote on {eng.device}] singular values of H "
          f"{torch.linalg.svdvals(h.H).cpu().numpy().tolist()}; "
          f"{'; '.join(rows)}; the engine's map holds candidate {pick} "
          f"(after the init BA)", flush=True)


def drive(label: str, eng, imgs, at: int, resume=None):
    """``chip_smoke.long_drive`` over all frames, its outcome printed;
    returns the engine's own state after frame ``at``."""
    import chip_smoke
    t0 = time.perf_counter()
    rows, _, own = chip_smoke.long_drive(eng, imgs, len(imgs), at, resume)
    codes = rows[:, 0].astype(int)
    lost = (codes != 2) & (np.arange(len(codes)) > at)
    st = eng.state
    out = {"tracked": int((codes == 2).sum()),
           "first_lost": int(np.argmax(lost)) if lost.any() else -1,
           "kf_ever": int(st.map.num_kf_ever),
           "kf_alive": int(st.map.kf_valid.sum()),
           "loops": eng.loops_closed,
           "kf_frames": [i for i in range(130) if rows[i, 12] > 0],
           "inliers_78_86": rows[78:87, 8].astype(int).tolist(),
           "seconds": time.perf_counter() - t0,
           "syncs_per_frame": eng.host_syncs / len(imgs)}
    print(f"[{label}] {out}", flush=True)
    return own


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    import torch
    if not args.cpu and not torch.cuda.is_available():
        print("probe_torch_long_init: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from mageslam_tpu_torch import MageSlamSettings, convert
    from mageslam_tpu_torch.runtime.fused import MageSlamTorchFused

    device = "cpu" if args.cpu else None
    if args.cpu:
        torch.set_num_threads(CPU_THREADS)
    else:
        from mageslam_tpu_torch.ops import fast_cuda
        fast_cuda.build()
        print(chip_smoke.run_text(["nvidia-smi",
                                   "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"]), flush=True)
    with np.load(chip_smoke.LONG_FIXTURE) as z:
        imgs = chip_smoke.long_frames(np, z)
        settings = MageSlamSettings.from_json(str(z["settings_json"]))
        cal = chip_smoke.calibration(z)
        at = int(z["init_frame"])
        jax_kf = [i for i in range(1, 130)
                  if z["s1_kf"][i, 0] > z["s1_kf"][i - 1, 0]]
        init_vote(MageSlamTorchFused(settings, cal, seed=1, device=device),
                  imgs, at)
        print(f"[JAX seed 1] tracked {int(z['s1_tracked'])}, keyframes "
              f"inserted at {jax_kf} (decided one frame before)",
              flush=True)
        eng = MageSlamTorchFused(settings, cal, seed=1, device=device)
        drive("resumed from JAX's initialization", eng, imgs, at,
              convert.engine_state_from_npz(z, "init_post/",
                                            device=eng.device))
    for seed in SEEDS:
        eng = MageSlamTorchFused(settings, cal, seed=seed, device=device)
        own = drive(f"own initialization, seed {seed}", eng, imgs, at)
        if seed == 1:
            OWN_INIT.parent.mkdir(exist_ok=True)
            np.savez_compressed(OWN_INIT, device=np.array(str(eng.device)),
                                **leaves(convert.to_numpy(own)))
            print(f"wrote {OWN_INIT.relative_to(ROOT)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
