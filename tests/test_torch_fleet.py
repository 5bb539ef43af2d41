"""The port's session fleet (``mageslam_tpu_torch/parallel/fleet``): 4
streams x 14 frames on the CPU at ``fast_settings()``, on the worlds of
``tests/test_fleet.py``, held against the JAX fleet's drive of the same
frames stored in ``tests/data/torch_parallel.npz`` (``fleet4_*``: each
stream tracks within ``tol/fleet_tracked`` frames of JAX's), and stream 0
against a solo ``DeviceEngine`` fed the same frames with the same seed,
bit for bit in every slot of the output row."""

from pathlib import Path

import numpy as np
import pytest
import torch

from mageslam_tpu_torch import MageSlamSettings
from mageslam_tpu_torch.io.synthetic import (FLEET_SEED, fleet_frames,
                                             frame_crcs)
from mageslam_tpu_torch.parallel.fleet import (SlamFleet, default_mesh,
                                               stream_seed)
from mageslam_tpu_torch.runtime import device_engine as de

torch.set_num_threads(2)
FIXTURE = Path(__file__).parent / "data" / "torch_parallel.npz"
N_STREAMS, N_FRAMES = 4, 14


@pytest.fixture(scope="module")
def z():
    with np.load(FIXTURE) as f:
        yield f


@pytest.fixture(scope="module")
def drive(z):
    imgs, cal = fleet_frames(N_STREAMS, N_FRAMES)
    settings = MageSlamSettings.from_json(str(z["fleet4_settings_json"]))
    fleet = SlamFleet(settings, cal, mesh=["cpu"] * N_STREAMS,
                      seed=FLEET_SEED)
    for f in range(N_FRAMES):
        fleet.process_frames(imgs[f], timestamps=np.full(N_STREAMS,
                                                         f / 30.0))
    fleet.flush()
    return fleet, imgs, cal, settings


def test_frames_are_the_fixtures(z, drive):
    _, imgs, _, _ = drive
    assert np.array_equal(frame_crcs(imgs), z["fleet4_crc"])


def test_streams_track_as_jax(z, drive):
    """Each stream initializes and tracks within the fixture's tolerance
    of the JAX fleet's stream on the same frames; its keyframe count by
    the last frame is JAX's."""
    fleet, _, _, _ = drive
    codes = np.stack([fleet.codes(f) for f in range(N_FRAMES)], 1)
    jcodes = z["fleet4_rows"][..., 0].astype(np.int32)
    tracked = (codes == de.CODE_TRACKING).sum(1)
    jtracked = (jcodes == de.CODE_TRACKING).sum(1)
    assert (np.abs(tracked - jtracked)
            <= int(z["tol/fleet_tracked"])).all(), (tracked, jtracked)
    assert (fleet.codes(N_FRAMES - 1) == de.CODE_TRACKING).all()
    assert np.array_equal(fleet.num_keyframes, z["fleet4_num_keyframes"])
    # the streams built maps of their own (different worlds)
    assert len(set(fleet.num_map_points.tolist())) > 1


def test_matches_single_engine(drive):
    """Stream 0 equals a solo engine with the stream's seed on the same
    frames: the whole output row, determinism hashes included (the same
    code on the same device)."""
    fleet, imgs, cal, settings = drive
    eng = de.DeviceEngine(settings, cal, "cpu",
                          seed=stream_seed(FLEET_SEED, 0))
    st = eng.empty_state()
    for f in range(N_FRAMES):
        st, out = eng.step(st, torch.as_tensor(imgs[f, 0]),
                           float(np.float32(f / 30.0)), f)
        assert np.array_equal(out.numpy(), fleet._results[f][0]), f


def test_stream_state_and_queries(drive):
    fleet, _, _, _ = drive
    st0 = fleet.stream_state(0)
    assert st0.map.kf_valid.ndim == 1
    assert int(st0.map.kf_valid.sum()) == fleet.num_keyframes[0]
    f = N_FRAMES - 1
    assert fleet.codes(f).shape == (N_STREAMS,)
    assert fleet.poses(f).shape == (N_STREAMS, 7)
    assert np.array_equal(fleet.poses(f), fleet._results[f][:, 1:8])
    assert np.isfinite(fleet.poses(f)).all()


def test_seeds_and_default_mesh(monkeypatch):
    """Stream seeds are distinct and fixed; the default mesh is the card's
    (raises without one)."""
    seeds = [stream_seed(3, i) for i in range(8)]
    assert len(set(seeds)) == 8
    assert seeds == [stream_seed(3, i) for i in range(8)]
    assert stream_seed(3, 0) != stream_seed(4, 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        default_mesh(4)
