"""Where the port's initialization parts from the JAX package's on the same
draws: the attempts of ``tests/data/torch_init_attempts.npz``.

For every stored attempt it prints each package's verdict; for each
attempt on which they disagree, whether the essential RANSAC's 8-point
pool alone gives both the same inliers and how many 5-point samples give
other candidate scores; then the success counts again with the port's
SVD (``ops/util.svd``) replaced by the JAX package's, which isolates the
5-point pool's nullspace basis (it depends on the LAPACK build), and for
each attempt on which the two still disagree, the stage where they part:
the essential RANSAC's result beside JAX's stored one, and the verdict
with JAX's result injected.

Run from the repository root (about 3 minutes on the CPU):

    JAX_PLATFORMS=cpu python tools/diagnose_torch_init_rate.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def pools(z, a: int, si, fx: float) -> str:
    """The essential RANSAC of attempt ``a`` in both packages: the 8-point
    pool alone, and the 5-point candidates' scores."""
    import jax
    import jax.numpy as jnp
    import torch
    from mageslam_tpu.solvers import essential as jess
    from mageslam_tpu_torch.solvers import essential as tess
    from mageslam_tpu_torch.tracking import initialization as tinit
    from test_torch_host_engine import JaxDraws
    from test_torch_init_rate import frame_features

    f0 = frame_features(z, int(z["att_partner"][a]))
    f1 = frame_features(z, int(z["att_frame"][a]))
    key = jax.random.wrap_key_data(jnp.asarray(z["att_key"][a]))
    draws = tinit.draw_init(JaxDraws(key), f0, f1, si)
    idx, dist = tinit._match(f0, f1, si)
    ok = idx >= 0
    x0, x1 = f0.xn_undist, f1.xn_undist[torch.clamp(idx, min=0).long()]
    px = 1.0 / fx
    thr = float(np.float32(si.fundamental_transfer_error_threshold * px))
    spread = float(np.float32(si.min_pixel_spread * px))
    kE, _ = jax.random.split(key)
    args = (jnp.asarray(x0.numpy()), jnp.asarray(x1.numpy()),
            jnp.asarray(ok.numpy()))
    kw = dict(inlier_thresh=jnp.float32(thr),
              min_pixel_spread=jnp.float32(spread), num_hypotheses=1024,
              sample_weight=jnp.exp(-jnp.asarray(dist.numpy())
                                    .astype(jnp.float32) / 12.0))
    j8 = jess.essential_ransac(kE, *args, use_five_point=False, **kw)
    t8 = tess.essential_ransac_from_samples(x0, x1, ok, thr, spread,
                                            draws.e8)
    same8 = np.array_equal(np.asarray(j8.inliers), t8.inliers.numpy())
    # the 5-point candidates of each package, scored alike
    from mageslam_tpu.solvers.five_point import five_point_essential as j5
    from mageslam_tpu_torch.solvers.five_point import \
        five_point_essential as t5
    e5 = draws.e5
    Ej, okj = jax.vmap(j5)(args[0][e5.numpy()], args[1][e5.numpy()])
    Et, okt = t5(x0[e5], x1[e5])
    nj = np.asarray(okj).sum(1)
    nt = okt.numpy().sum(1)
    return (f"8-point pool alone: same inliers {same8} ({int(j8.num_inliers)}"
            f" / {int(t8.num_inliers)}); 5-point samples with another count"
            f" of candidates: {int((nj != nt).sum())} of {len(nj)}")


def parting(z, a: int, si, fx: float) -> str:
    """Attempt ``a`` under the current SVD: the port's essential result
    beside JAX's stored one, and the port's verdict with JAX's injected
    (equal to JAX's verdict: they part at the essential RANSAC)."""
    import jax
    import jax.numpy as jnp
    import torch
    from mageslam_tpu_torch.solvers import essential as tess
    from mageslam_tpu_torch.tracking import initialization as tinit
    from test_torch_host_engine import JaxDraws
    from test_torch_init_rate import frame_features

    f0 = frame_features(z, int(z["att_partner"][a]))
    f1 = frame_features(z, int(z["att_frame"][a]))
    key = jax.random.wrap_key_data(jnp.asarray(z["att_key"][a]))
    draws = tinit.draw_init(JaxDraws(key), f0, f1, si)
    idx, _ = tinit._match(f0, f1, si)
    x0, x1 = f0.xn_undist, f1.xn_undist[torch.clamp(idx, min=0).long()]
    px = 1.0 / fx
    thr = float(np.float32(si.fundamental_transfer_error_threshold * px))
    spread = float(np.float32(si.min_pixel_spread * px))
    mine = tess.essential_ransac_from_samples(x0, x1, idx >= 0, thr, spread,
                                              draws.e8, draws.e5)
    jinl = z["att_ess_inliers"][a]
    gap = float(np.abs(mine.rel_pose.numpy() - z["att_ess_rel_pose"][a])
                .max())
    carried = tess.EssentialResult(*(
        torch.as_tensor(z["att_ess_" + f][a])
        for f in tess.EssentialResult._fields))
    run = tinit.essential.essential_ransac_from_samples
    tinit.essential.essential_ransac_from_samples = \
        lambda *args, **kw: carried
    try:
        r = tinit.attempt_initialization(draws, f0, f1, si, fx)
    finally:
        tinit.essential.essential_ransac_from_samples = run
    return (f"essential inliers {int(mine.num_inliers)} (JAX "
            f"{int(z['att_ess_num_inliers'][a])}), same inlier set "
            f"{np.array_equal(mine.inliers.numpy(), jinl)}, relative pose "
            f"up to {gap:.3g} from JAX's; with JAX's essential result "
            f"injected: success {bool(r.success)}, points "
            f"{int(r.num_points)} (JAX {bool(z['att_success'][a])}, "
            f"{int(z['att_num_points'][a])})")


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    from mageslam_tpu_torch.config import MageSlamSettings
    from mageslam_tpu_torch.ops import util
    from test_torch_init_rate import attempts_of, replay, report

    torch.set_num_threads(2)
    z = np.load(ROOT / "tests" / "data" / "torch_init_attempts.npz")
    si = MageSlamSettings.from_json(str(z["settings_json"])).mono.map_init
    fx = float(np.float32(z["cal"][0]))
    attempts = attempts_of(z, tuple(z["init_seeds"]))
    rows = replay(z, attempts)
    print("port as it is:")
    report(rows)
    for r in rows:
        if r["jax"][0] != r["port"][0]:
            print(f"  seed {r['seed']} frames {r['pair']}: "
                  f"{pools(z, r['attempt'], si, fx)}")

    def jax_svd(A, full_matrices=False):
        out = jnp.linalg.svd(jnp.asarray(A.cpu().numpy()),
                             full_matrices=full_matrices)
        return tuple(torch.as_tensor(np.array(x)) for x in out)

    svd, util.svd = util.svd, jax_svd
    try:
        print("port with the JAX package's SVD:")
        rows = replay(z, attempts)
        report(rows)
        for r in rows:
            if r["jax"][0] != r["port"][0]:
                print(f"  seed {r['seed']} frames {r['pair']}: "
                      f"{parting(z, r['attempt'], si, fx)}")
    finally:
        util.svd = svd


if __name__ == "__main__":
    main()
