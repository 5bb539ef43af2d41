"""A run of the harness with its timed path broken underneath must come
out not correct; a sound run, correct.  The look for a card is skipped
(``run_cell`` on the CPU) and the cell is cut to what a test run holds:
the explore walk with a 20-frame warm-up and a few frames in the
window.  One case per fault the cell can have:

- ``features_half``: half of the frame's features left out where the
  frontend produces them;
- ``matches_half``: every other candidate's match dropped where
  tracking's matching produces it;
- ``pose_altered``: the tracking pose altered where it is produced;
- ``ba_unchanged``: local BA returns its window unchanged.
"""

import copy

import pytest

from slambench import check, harness

CELL = "console320-explore"


@pytest.fixture(autouse=True)
def every_frame_matched(monkeypatch):
    """Keep the matching of every window frame: the cut window is too
    short for a sample of one frame in eight."""
    monkeypatch.setattr(check, "TRACK_SHARE", 1.0)


@pytest.fixture(scope="module")
def spec():
    s = harness.cell_spec(harness.manifest(), CELL)
    s["traffic"] = dict(s["traffic"], warmup_frames=20, max_fps=8)
    return s


@pytest.mark.parametrize("fault, number", [
    (None, None), ("features_half", "frontend_mismatch"),
    ("matches_half", "match_mismatch"), ("pose_altered", "pose_gap_px"),
    ("ba_unchanged", "ba_gap_px")])
def test_broken_path_is_not_correct(spec, fault, number):
    out = harness.run_cell(CELL, 77, 6.0, False, device="cpu", fault=fault,
                           spec=copy.deepcopy(spec))
    if fault is None:
        assert out["checks"]["uninitialized"]["value"] == 0
        assert out["correct"], out["checks"]
        return
    assert not out["correct"]
    c = out["checks"][number]
    assert c["value"] > c["limit"], out["checks"]
