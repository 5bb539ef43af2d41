"""The traffic generator: deterministic per seed, the stated motion, no
return in the explore walk, and a seed that draws textures and noise but
not geometry."""

import math

import pytest
import torch

from slambench import generator

SMALL = dict(width=64, height=36)


def small(name, **over):
    t = generator.load_traffic(name)
    t.update(SMALL, **over)
    return t


@pytest.mark.parametrize("name", ["explore", "look"])
def test_same_seed_same_frames(name):
    t = small(name)
    a = generator.render(t, 2 ** 40 + 7, 3, "cpu")
    b = generator.render(t, 2 ** 40 + 7, 3, "cpu")
    assert a.dtype == torch.uint8 and a.shape == (3, 36, 64)
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["explore", "look"])
def test_seed_changes_texture_not_geometry(name):
    t = small(name)
    a = generator.render(t, 1, 2, "cpu")
    b = generator.render(t, 2, 2, "cpu")
    assert not torch.equal(a, b)
    ga = generator.World(t, 50, torch.Generator().manual_seed(1), "cpu")
    gb = generator.World(t, 50, torch.Generator().manual_seed(2), "cpu")
    # the same number of patches over the same extent: density is fixed
    assert ga.num == gb.num
    assert torch.equal(generator.gt_poses(t, 50), generator.gt_poses(t, 50))


def test_explore_motion_per_frame():
    t = generator.load_traffic("explore")
    R, c = generator.camera_path(t, 400, "cpu")
    step = torch.linalg.vector_norm(c[1:, [0, 2]] - c[:-1, [0, 2]], dim=-1)
    # loop_trajectory(150, radius=3.0): 3 * 2 pi * 1.12 / 149 m a frame,
    # at the traffic's stated share of that pace
    pace = t["path"]["pace_of_ring_drive"]
    assert 0 < pace <= 1
    want = pace * 3.0 * 2 * math.pi * 1.12 / 149
    assert torch.allclose(step, torch.full_like(step, want), rtol=1e-3)
    climb = c[1:, 1] - c[:-1, 1]
    th = generator.helix_step(t["path"])
    bob = 0.08 * 3 * th
    rise = t["world"]["pitch"] * th / (2 * math.pi)
    assert float(climb.abs().max()) <= rise + bob + 1e-9


def test_explore_never_returns():
    """After one turn the camera is a pitch higher, and the band of wall
    it saw then (half height 3 m, patches of up to 0.4 m half side) lies
    below what the view spans at the farthest wall: the walk meets no
    ground twice within the frames made."""
    t = generator.load_traffic("explore")
    w, p = t["world"], t["path"]
    frames = int(t["warmup_frames"] + t["max_fps"] * 51 + 1)
    _, c = generator.camera_path(t, frames, "cpu")
    per_turn = int(math.ceil(2 * math.pi / generator.helix_step(p)))
    rise = torch.abs(c[per_turn:, 1] - c[:-per_turn, 1])
    assert float(rise.min()) >= w["pitch"] - 2 * p["bob"]
    far = w["r_out"] + p["radius"]
    half_view = far * (t["height"] / 2) / (0.85 * t["width"])
    assert w["pitch"] - 2 * p["bob"] > w["half_height"] + 0.4 + half_view


def test_look_stays_near_one_view():
    t = generator.load_traffic("look")
    _, c = generator.camera_path(t, 600, "cpu")
    assert float(torch.linalg.vector_norm(c, dim=-1).max()) < 2.0
    # back and forth: the sweep returns to the start each period
    p = int(t["path"]["period"])
    assert torch.allclose(c[p], c[0], atol=1e-9)
