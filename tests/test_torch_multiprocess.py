"""Multi-process certification of the port's distributed BA
(``mageslam_tpu_torch/parallel/multiprocess``): two spawned processes,
joined over gloo, four CPU shards each, form the 8-shard global mesh and
run the standalone distributed BA and the engine-routed global BA.  Their
results must be bit-identical to each other and to an in-process run on 8
CPU shards (the ordered reduction, ``Mesh.reduce``), within the fixture's
tolerances of the JAX package's certification
(``tests/data/torch_parallel.npz``, ``cert_*``), and converged."""

from pathlib import Path

import numpy as np
import pytest
import torch

from mageslam_tpu_torch.parallel import multiprocess as mp
from mageslam_tpu_torch.parallel.distributed_ba import make_mesh

torch.set_num_threads(2)
FIXTURE = Path(__file__).parent / "data" / "torch_parallel.npz"


@pytest.fixture(scope="module")
def mp_results():
    return mp.spawn_certification(num_processes=2, local_devices=4,
                                  timeout=300.0, device="cpu")


def test_processes_joined_global_mesh(mp_results):
    results, logs = mp_results
    assert len(results) == 2
    for r in results:
        assert int(r["n_global_devices"]) == 8
    for log in logs:
        assert "local=4 global=8 processes=2" in log, log[-2000:]


def test_processes_bitwise_identical(mp_results):
    results, _ = mp_results
    for key in mp.RESULT_KEYS + ("standalone_mse", "engine_mse"):
        assert np.array_equal(results[0][key], results[1][key]), key


def test_matches_single_process(mp_results):
    results, _ = mp_results
    ref = mp.run_certification(make_mesh(devices=["cpu"] * 8))
    for key in mp.RESULT_KEYS + ("standalone_mse", "engine_mse"):
        assert np.array_equal(ref[key], results[0][key]), key


def test_matches_jax_certification(mp_results):
    results, _ = mp_results
    r = results[0]
    with np.load(FIXTURE) as z:
        for kind in ("standalone", "engine"):
            np.testing.assert_allclose(r[f"{kind}_poses"],
                                       z[f"cert_{kind}_poses"],
                                       atol=float(z["tol/cert_poses"]))
            np.testing.assert_allclose(r[f"{kind}_points"],
                                       z[f"cert_{kind}_points"],
                                       atol=float(z["tol/cert_points"]))
            assert float(r[f"{kind}_mse"]) == pytest.approx(
                float(z[f"cert_{kind}_mse"]),
                rel=float(z["tol/cert_mse_rel"]))


def test_engine_ba_converged(mp_results):
    results, _ = mp_results
    # 3e-4 observation noise: the BA must have solved it
    assert float(results[0]["standalone_mse"]) < 1e-6
    assert float(results[0]["engine_mse"]) < 1e-6
