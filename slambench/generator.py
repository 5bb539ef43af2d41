"""The one traffic generator: a synthetic world, a camera path and a
renderer, all read from a traffic file (``slambench/traffic/<name>.json``).

A frozen copy of the port's synthetic world (``io/synthetic.py``:
value-noise background, inward-facing textured wall patches of
``create_ring``, the point cloud of ``create``, ``loop_trajectory`` and
``orbit_trajectory``), rewritten in PyTorch so that frames are made on the
card in a few large calls.  Nothing here imports the program: later
changes to the program cannot move the yardstick.

The seed draws the world's points, their sizes, intensities and textures,
and the sensor noise.  It does not draw the path, the speed or the
density of the scene, so every seed gives the same work in distribution.

World kinds:

- ``wall_helix``: the ring world's wall (radii ``r_in``-``r_out``, a band
  ``2 * half_height`` high, ``grid`` = (cells per turn, cells in height)
  patches per turn: 900 as ``create_ring(900)``) wound into a helix that
  climbs ``pitch`` metres a turn, so the band seen on one turn is out of
  view on the next.  The background is the ring world's cylinder, its
  texture taken over the unwound azimuth.
- ``cloud``: the point cloud of ``SyntheticWorld.create`` in a box
  (``grid`` cells, one patch each), over a textured plane ``bg_depth``
  metres down the z axis.

Patches are stratified: one per cell of the grid, at a uniform place
inside it, where the port's worlds draw every position uniformly over the
whole extent; so a seed cannot thin out a stretch of wall, and every seed
holds the same density at every scale.

Path kinds:

- ``helix``: ``loop_trajectory``'s circle (radius, the angle per frame,
  look-ahead and vertical bob) lifted by the helix's pitch.
- ``sweep``: ``orbit_trajectory``'s arc without forward drift, swept back
  and forth with a fixed period, always looking at one target.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
GRID = 5                       # texture cells per patch side
SEED_MASK = (1 << 63) - 1      # torch generators take seeds below 2**64


def load_traffic(name: str) -> dict:
    """The traffic mix ``slambench/traffic/<name>.json``."""
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def calibration(t: dict) -> dict:
    """Pinhole intrinsics of the traffic's frames (``default_calibration``:
    focal length ``focal_ratio`` of the width, centred principal point)."""
    w, h = int(t["width"]), int(t["height"])
    f = float(t["focal_ratio"]) * w
    return dict(fx=f, fy=f, cx=w / 2.0, cy=h / 2.0, width=w, height=h)


# ---------------------------------------------------------------- paths
def _look_rotation(fwd: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) camera-from-world rotations whose rows are the camera's
    right, up and forward axes (world up is +y)."""
    fwd = fwd / torch.linalg.vector_norm(fwd, dim=-1, keepdim=True)
    up = torch.zeros_like(fwd)
    up[:, 1] = 1.0
    right = torch.linalg.cross(up, fwd, dim=-1)
    right = right / torch.linalg.vector_norm(right, dim=-1, keepdim=True)
    upv = torch.linalg.cross(fwd, right, dim=-1)
    return torch.stack([right, upv, fwd], 1)


def helix_step(p: dict) -> float:
    """Radians a frame on the helix: ``loop_trajectory(150)``'s
    2 pi 1.12 / 149 scaled by the path's ``pace_of_ring_drive``."""
    return float(p["pace_of_ring_drive"]) * 2 * math.pi * 1.12 / 149


def camera_path(t: dict, n: int, device) -> tuple:
    """(R (n, 3, 3) camera-from-world, c (n, 3) camera centres), float64."""
    p = t["path"]
    i = torch.arange(n, dtype=torch.float64, device=device)
    if p["kind"] == "helix":
        th = helix_step(p) * i
        rise = t["world"]["pitch"] * th / (2 * math.pi)
        c = torch.stack([p["radius"] * torch.cos(th),
                         rise + p["bob"] * torch.sin(3.0 * th),
                         p["radius"] * torch.sin(th)], -1)
        tangent = torch.stack([-torch.sin(th), torch.zeros_like(th),
                               torch.cos(th)], -1)
        outward = torch.stack([torch.cos(th), torch.zeros_like(th),
                               torch.sin(th)], -1)
        fwd = tangent + p["look_ahead"] * outward
    elif p["kind"] == "sweep":
        ang = p["sweep_rad"] * torch.sin(2 * math.pi * i / p["period"])
        c = torch.stack([p["radius"] * torch.sin(ang),
                         p["lift"] * torch.sin(2.0 * ang),
                         torch.zeros_like(ang)], -1)
        target = torch.tensor(p["look_at"], dtype=torch.float64,
                              device=device)
        fwd = target - c
    else:
        raise ValueError(f"unknown path kind {p['kind']!r}")
    return _look_rotation(fwd), c


def gt_poses(t: dict, n: int, device="cpu") -> torch.Tensor:
    """(n, 4, 4) float64 camera-from-world transforms of the path."""
    R, c = camera_path(t, n, device)
    T = torch.zeros((n, 4, 4), dtype=torch.float64, device=device)
    T[:, :3, :3] = R
    T[:, :3, 3] = -(R @ c[..., None])[..., 0]
    T[:, 3, 3] = 1.0
    return T


# ---------------------------------------------------------------- world
class World:
    """Patches (centre, in-plane axes, half side, intensity, texture) and
    the background surface, on one device, float32 except the geometry."""

    def __init__(self, t: dict, n_frames: int, gen: torch.Generator,
                 device):
        w = t["world"]
        self.kind = w["kind"]
        self.w = w
        dev = torch.device(device)
        f64 = dict(dtype=torch.float64, device=dev)
        if self.kind == "wall_helix":
            # the wall covers the turns the path makes, plus a margin on
            # each side for what the camera sees ahead and behind
            step = helix_step(t["path"])
            lo = -w["margin_rad"]
            hi = step * max(n_frames - 1, 0) + w["margin_rad"]
            # stratified: one patch per cell of a grid over (angle,
            # height), jittered inside its cell, so every seed has the
            # same density at every scale; the radius is drawn in full
            n_ang, n_h = (int(v) for v in w["grid"])
            per_cell = 2 * math.pi / n_ang
            cells_a = int(math.ceil((hi - lo) / per_cell))
            num = cells_a * n_h
            u = torch.rand((num, 3), generator=gen, **f64)
            ia = torch.arange(num, device=dev) // n_h
            ih = torch.arange(num, device=dev) % n_h
            ang = lo + (ia + u[:, 0]) * per_cell
            rad = w["r_in"] + (w["r_out"] - w["r_in"]) * u[:, 1]
            y = w["pitch"] * ang / (2 * math.pi) + w["half_height"] * (
                2.0 * (ih + u[:, 2]) / n_h - 1.0)
            pts = torch.stack([rad * torch.cos(ang), y,
                               rad * torch.sin(ang)], -1)
            normals = -torch.stack([torch.cos(ang), torch.zeros_like(ang),
                                    torch.sin(ang)], -1)
        elif self.kind == "cloud":
            # stratified as above: one point per cell of a 3-D grid
            g = torch.tensor([int(v) for v in w["grid"]], device=dev)
            num = int(g.prod())
            u = torch.rand((num, 3), generator=gen, **f64)
            k = torch.arange(num, device=dev)
            idx = torch.stack([k // (g[1] * g[2]), (k // g[2]) % g[1],
                               k % g[2]], -1)
            unit = (idx + u) / g                          # in [0, 1)
            pts = (2.0 * unit - 1.0) * torch.tensor(w["extent"], **f64) \
                + torch.tensor(w["center"], **f64)
            normals = torch.zeros_like(pts)
            normals[:, 2] = 1.0
        else:
            raise ValueError(f"unknown world kind {self.kind!r}")
        look = torch.rand((num, 2), generator=gen, **f64)
        self.intensity = (150.0 + 100.0 * look[:, 0]).to(torch.float32)
        self.half_side = (8.0 + 8.0 * look[:, 1]) / 40.0
        grid = torch.rand((num, GRID, GRID), generator=gen, device=dev) > 0.45
        grid[:, GRID // 2, GRID // 2] = True   # the point itself on texture
        self.tex = grid.to(torch.float32)
        up = torch.zeros_like(normals)
        up[:, 1] = 1.0
        up[normals[:, 1].abs() >= 0.9] = torch.tensor([1.0, 0.0, 0.0], **f64)
        e1 = torch.linalg.cross(up, normals, dim=-1)
        e1 = e1 / torch.linalg.vector_norm(e1, dim=-1, keepdim=True)
        self.e1 = e1
        self.e2 = torch.linalg.cross(normals, e1, dim=-1)
        self.points = pts
        self.normals = normals
        self.num = num


def _value_noise(px, py, scale: float, salt: float):
    x, y = px / scale, py / scale
    i, j = torch.floor(x), torch.floor(y)
    fx, fy = x - i, y - j
    fx = fx * fx * (3.0 - 2.0 * fx)
    fy = fy * fy * (3.0 - 2.0 * fy)

    def h(a, b):
        v = torch.sin(a * 12.9898 + b * 78.233 + salt) * 43758.5453
        return v - torch.floor(v)

    return (h(i, j) * (1 - fx) * (1 - fy) + h(i + 1, j) * fx * (1 - fy)
            + h(i, j + 1) * (1 - fx) * fy + h(i + 1, j + 1) * fx * fy)


def _surface_texture(px, py):
    t = (0.55 * _value_noise(px, py, 2.3, 0.0)
         + 0.30 * _value_noise(px, py, 0.83, 5.1)
         + 0.15 * _value_noise(px, py, 0.31, 11.7))
    return 18.0 + 72.0 * t


def _background(world: World, rays_w, c, cam_angle):
    """Background grey levels (H, W) of one view: ray hits on the ring
    world's cylinder (texture over the azimuth unwound about the camera's
    own angle) or on the plane z = bg_depth."""
    w = world.w
    if world.kind == "wall_helix":
        R = w["r_out"] + 2.0
        dx, dz = rays_w[..., 0], rays_w[..., 2]
        a = dx * dx + dz * dz
        b = 2.0 * (c[0] * dx + c[2] * dz)
        cc = c[0] * c[0] + c[2] * c[2] - R * R
        disc = torch.clamp(b * b - 4 * a * cc, min=0.0)
        tt = (-b + torch.sqrt(disc)) / torch.clamp(2 * a, min=1e-9)
        az = torch.atan2(c[2] + tt * dz, c[0] + tt * dx)
        az = cam_angle + torch.remainder(az - cam_angle + math.pi,
                                         2 * math.pi) - math.pi
        px = az * R
        py = c[1] + tt * rays_w[..., 1]
    else:
        tt = (w["bg_depth"] - c[2]) / torch.clamp(rays_w[..., 2], min=1e-6)
        px = c[0] + tt * rays_w[..., 0]
        py = c[1] + tt * rays_w[..., 1]
    return _surface_texture(px, py)


def render(t: dict, seed: int, n_frames: int,
           device="cpu") -> torch.Tensor:
    """(n_frames, H, W) uint8 frames of the traffic ``t`` at ``seed``, on
    ``device``.  Patches are drawn far to near by centre depth, as the
    port's renderer draws them; sensor noise is Gaussian of
    ``t["noise"]`` grey levels."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) & SEED_MASK)
    world = World(t, n_frames, gen, dev)
    cal = calibration(t)
    H, W = cal["height"], cal["width"]
    R_all, c_all = camera_path(t, n_frames, dev)
    vv, uu = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=dev),
                            torch.arange(W, dtype=torch.float64, device=dev),
                            indexing="ij")
    rays = torch.stack([(uu - cal["cx"]) / cal["fx"],
                        (vv - cal["cy"]) / cal["fy"],
                        torch.ones_like(uu)], -1).reshape(-1, 3)
    cap = int(t["max_visible"])
    step = helix_step(t["path"]) if t["path"]["kind"] == "helix" else 0.0
    out = torch.empty((n_frames, H, W), dtype=torch.uint8, device=dev)
    fx, fy, cx, cy = cal["fx"], cal["fy"], cal["cx"], cal["cy"]
    P = world.points
    for f in range(n_frames):
        R, c = R_all[f], c_all[f]
        rays_w = rays @ R                               # R^T applied per ray
        # flat (H * W,) grey levels until the frame is written
        img = _background(world, rays_w, c, step * f).to(torch.float32)
        img = img + float(t["noise"]) * torch.randn(
            img.shape, generator=gen, device=dev, dtype=torch.float32)
        # visible patch centres: in front, projecting near the image, and
        # every corner in front of the camera
        xc = P @ R.T - (R @ c)[None]
        z = xc[:, 2]
        u = fx * xc[:, 0] / torch.clamp(z, min=1e-6) + cx
        v = fy * xc[:, 1] / torch.clamp(z, min=1e-6) + cy
        vis = (z > 0.25) & (u > -40) & (u < W + 40) & (v > -40) & (v < H + 40)
        s = world.half_side[:, None, None]
        sgn = torch.tensor([[-1.0, -1.0], [1.0, -1.0], [-1.0, 1.0],
                            [1.0, 1.0]], dtype=torch.float64, device=dev)
        corners = P[:, None] + s * (sgn[None, :, :1] * world.e1[:, None]
                                    + sgn[None, :, 1:] * world.e2[:, None])
        cz = (corners @ R.T - (R @ c))[..., 2]
        vis &= (cz >= 0.2).all(1)
        idx = torch.nonzero(vis).flatten()
        if idx.numel() > cap:
            raise RuntimeError(f"frame {f}: {idx.numel()} patches in view, "
                               f"max_visible is {cap}")
        if idx.numel():
            pz, n_ = P[idx], world.normals[idx]
            denom = rays_w @ n_.T                              # (HW, K)
            denom = torch.where(denom.abs() < 1e-9,
                                torch.full_like(denom, 1e-9), denom)
            ti = ((pz - c) * n_).sum(-1)[None] / denom
            # in-plane coordinates of the hit c + ti * ray - pz
            e1, e2 = world.e1[idx], world.e2[idx]
            hs = 2.0 * world.half_side[idx][None]
            un = (((c - pz) * e1).sum(-1)[None] + ti * (rays_w @ e1.T)) \
                / hs + 0.5
            vn = (((c - pz) * e2).sum(-1)[None] + ti * (rays_w @ e2.T)) \
                / hs + 0.5
            inside = (un >= 0) & (un < 1) & (vn >= 0) & (vn < 1) & (ti > 0)
            # the nearest patch centre wins (drawn last, far to near)
            key = torch.where(inside, z[idx][None],
                              torch.full_like(un, float("inf")))
            best = torch.argmin(key, 1)
            hit = torch.isfinite(key.gather(1, best[:, None])[:, 0])
            ub = un.gather(1, best[:, None])[:, 0]
            vb = vn.gather(1, best[:, None])[:, 0]
            k = idx[best]
            gx = torch.clamp(ub * GRID - 0.5, 0.0, GRID - 1.000001)
            gy = torch.clamp(vb * GRID - 0.5, 0.0, GRID - 1.000001)
            g0x, g0y = torch.floor(gx).long(), torch.floor(gy).long()
            g1x = torch.clamp(g0x + 1, max=GRID - 1)
            g1y = torch.clamp(g0y + 1, max=GRID - 1)
            wx, wy = gx - g0x, gy - g0y
            tg = world.tex
            cell = (tg[k, g0y, g0x] * (1 - wx) * (1 - wy)
                    + tg[k, g0y, g1x] * wx * (1 - wy)
                    + tg[k, g1y, g0x] * (1 - wx) * wy
                    + tg[k, g1y, g1x] * wx * wy)
            tex = world.intensity[k] * (0.12 + 0.88 * cell.to(torch.float32))
            img = torch.where(hit, tex, img)
        out[f] = torch.round(torch.clamp(img, 0.0, 255.0)).to(
            torch.uint8).reshape(H, W)
    return out
