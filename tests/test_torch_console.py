"""The port's console (``examples/console_torch.py``): the golden path from
disk against the JAX console's (``tests/data/torch_dataset.npz``,
``tools/make_torch_dataset_fixture.py``).

- The console's settings are the JAX console's ``fast_settings()``: the
  same JSON.
- A short run of ``main`` on the CPU reads ``mini_seq`` through the port's
  pump and writes the fossil CSV and TUM files.
- Step parity from the JAX drive's state after its first lasting
  tracking frame (8), over every later frame of the sequence (31, with
  three local-BA windows) read from disk by the port's pump: codes,
  keyframe flags, keyframe and map-point counts exact, poses within 1e-3.
- Slow: the whole 40-frame console drive (tracked at least JAX's count
  minus 3, initialized before frame 20, ATE under 1.5x the worst of JAX's
  ATEs at seeds 1-3, CSV and TUM read back) and the 150-frame
  ``ring_seq`` console drive by outcome against the spread of JAX's three
  seeds.
"""

import os
import sys

import numpy as np
import pytest
import torch

from mageslam_tpu_torch import convert
from mageslam_tpu_torch.io.datasets import load_dataset
from mageslam_tpu_torch.io.native_loader import read_image_gray
from mageslam_tpu_torch.runtime import device_engine as de
from mageslam_tpu_torch.runtime.results import TrackingState
from test_slam_e2e import fast_settings as jax_fast_settings
from test_torch_device_io import DATASET

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "examples"))
import console_torch  # noqa: E402

MINI_SEQ = os.path.join(ROOT, "tests", "data", "mini_seq")
RING_SEQ = os.path.join(ROOT, "tests", "data", "ring_seq")

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ds():
    return np.load(DATASET)


def test_settings_are_the_jax_consoles(ds):
    want = jax_fast_settings().to_json()
    assert console_torch.fast_settings().to_json() == want
    assert str(ds["con_settings_json"]) == want


def test_main_writes_the_fossil(tmp_path, capsys):
    csv, tum = tmp_path / "fossil.csv", tmp_path / "traj.tum"
    assert console_torch.main(["--cpu", "--dataset", MINI_SEQ,
                               "--max-frames", "12", "--csv", str(csv),
                               "--tum", str(tum)]) == 0
    out = capsys.readouterr().out
    assert "12 frames from" in out and "frame pump:" in out
    rows = np.loadtxt(csv, delimiter=",", ndmin=2)
    traj = np.loadtxt(tum, ndmin=2)
    assert rows.shape[1] == 17 and traj.shape == (len(rows), 8)
    assert f"({len(rows)} poses)" in out
    assert len(rows) >= 2 and np.isfinite(rows).all()


def test_console_steps_from_the_carried_state(ds):
    start = int(ds["cs_frame"])
    seq = load_dataset(MINI_SEQ)
    cal = seq.tracking_calibration(320)
    eng = de.DeviceEngine(console_torch.fast_settings(), cal, device="cpu")
    st = convert.engine_state_from_npz(ds, "cs_state/")
    rows = []
    for i in range(start + 1, len(seq.image_paths)):
        img = read_image_gray(seq.image_paths[i], 320, cal.height)
        st, out = eng.step(st, torch.as_tensor(img), float(
            seq.timestamps[i] - seq.timestamps[0]), i)
        rows.append(out.numpy())
    rows = np.stack(rows)
    want = ds["con_rows"][0][start + 1:]
    assert len(want) == 31
    for col in (0, 12, 9, 10):
        np.testing.assert_array_equal(rows[:, col], want[:, col],
                                      err_msg=f"output slot {col}")
    np.testing.assert_allclose(rows[:, 1:8], want[:, 1:8], atol=1e-3)


def drive(root, tmp_path):
    csv, tum = tmp_path / "fossil.csv", tmp_path / "traj.tum"
    out = console_torch.run(console_torch.parse_args(
        ["--cpu", "--dataset", root, "--csv", str(csv), "--tum", str(tum)]))
    fossil = out["fossil"]
    rows = np.loadtxt(csv, delimiter=",", ndmin=2)
    np.testing.assert_array_equal(rows[:, 0], fossil.frame_ids)
    np.testing.assert_allclose(rows[:, 1:], fossil.world_from_camera_mats()
                               .reshape(-1, 16), rtol=1e-6, atol=1e-7)
    assert np.loadtxt(tum, ndmin=2).shape == (len(rows), 8)
    return out


@pytest.mark.slow
def test_whole_console_drive(ds, tmp_path):
    out = drive(MINI_SEQ, tmp_path)
    states = [out["results"][i].state for i in range(out["count"])]
    last_init = max(i for i, s in enumerate(states)
                    if s == TrackingState.INITIALIZING)
    assert last_init < 20
    assert out["tracked"] >= int(ds["con_tracked"][0]) - 3
    assert out["ate"] < float(ds["con_ate_bound"])


@pytest.mark.slow
def test_ring_seq_console_drive(ds, tmp_path):
    """At the console's 32-keyframe capacity the ring fills the map and
    loses track near frame 85; how long it stays lost depends on the
    relocalization draws (JAX's own drives track 95-136 of 150 at seeds
    1-3), so the bounds take the seeds' spread."""
    out = drive(RING_SEQ, tmp_path)
    assert out["count"] == 150
    assert out["tracked"] >= int(ds["ring_tracked"].min()) - 5
    assert out["ate"] < 1.5 * float(ds["ring_ate"].max())
