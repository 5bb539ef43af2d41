"""Synthetic scene + sequence generation for tests and benchmarks.

A copy of ``mageslam_tpu/io/synthetic.py`` (numpy only) over the port's
``CameraCalibration``: the same seed renders the same images, bit for bit.

The reference's golden path consumes an OpenCV video (Apps/Console/
console.cpp:291-341).  With no camera or dataset on the box, this module
renders deterministic synthetic sequences with exact ground truth:

  - ``SyntheticWorld``: a random 3D point cloud with per-point intensity
    "texture"; ``render`` splats each visible point as a small bright square
    (strong FAST corners at all four square corners plus texture gradient)
    onto a noisy background, producing images the real frontend tracks.
  - trajectories: smooth orbits / arcs with known view poses, so ATE is
    measurable without EuRoC/TUM.

Everything is numpy on the host (data generation is not a device workload);
images come back as float32 (H, W) in [0, 255].
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

from mageslam_tpu_torch.geometry.camera import CameraCalibration


def _quat_to_mat_np(q: np.ndarray) -> np.ndarray:
    """Pure-numpy wxyz quaternion -> rotation matrix (same convention as
    geometry.se3.quat_to_mat).  The renderer stays on the host: it touches
    no device tensor."""
    w, x, y, z = (np.float64(v) for v in q[:4])
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n < 1e-12 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([[1 - yy - zz, xy - wz, xz + wy],
                     [xy + wz, 1 - xx - zz, yz - wx],
                     [xz - wy, yz + wx, 1 - xx - yy]])


def _mat_to_quat_np(R: np.ndarray) -> np.ndarray:
    """Pure-numpy rotation matrix -> wxyz quaternion (convention of
    geometry.se3.mat_to_quat; host only, as above)."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = np.array([(R[2, 1] - R[1, 2]) / s, 0.25 * s,
                      (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s])
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = np.array([(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s,
                      0.25 * s, (R[1, 2] + R[2, 1]) / s])
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = np.array([(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
                      (R[1, 2] + R[2, 1]) / s, 0.25 * s])
    q = q / np.linalg.norm(q)
    if q[0] < 0:
        q = -q
    return q


def _value_noise(px: np.ndarray, py: np.ndarray, scale: float,
                 salt: float) -> np.ndarray:
    """Deterministic aperiodic value noise over world coords (bilinear
    interpolation of hashed lattice values, smoothstep-weighted)."""
    x, y = px / scale, py / scale
    i, j = np.floor(x), np.floor(y)
    fx, fy = x - i, y - j
    fx = fx * fx * (3.0 - 2.0 * fx)
    fy = fy * fy * (3.0 - 2.0 * fy)

    def h(a, b):
        v = np.sin(a * 12.9898 + b * 78.233 + salt) * 43758.5453
        return v - np.floor(v)

    return (h(i, j) * (1 - fx) * (1 - fy) + h(i + 1, j) * fx * (1 - fy)
            + h(i, j + 1) * (1 - fx) * fy + h(i + 1, j + 1) * fx * fy)


def _surface_texture(px: np.ndarray, py: np.ndarray) -> np.ndarray:
    """Aperiodic multi-octave texture for background surfaces.  A periodic
    (plane-wave) texture aliases under prior-guided radius matching — the
    tracker can lock onto a shifted repeat and drag the pose — which real
    scenes don't do; value noise has no repeats."""
    t = (0.55 * _value_noise(px, py, 2.3, 0.0)
         + 0.30 * _value_noise(px, py, 0.83, 5.1)
         + 0.15 * _value_noise(px, py, 0.31, 11.7))
    return (18.0 + 72.0 * t).astype(np.float32)


@dataclass
class SyntheticWorld:
    points: np.ndarray       # (P, 3) world points
    intensities: np.ndarray  # (P,) point brightness
    sizes: np.ndarray        # (P,) splat half-size in px at depth 1
    tex_grid: np.ndarray     # (P, G, G) per-point binary texture pattern
    normals: np.ndarray = None  # (P, 3) patch plane normals (default +z)
    bg: str = "plane"           # background surface: "plane" | "cylinder"
    bg_radius: float = 30.0     # cylinder radius (bg == "cylinder")
    bg_image: np.ndarray = None  # (H, W) real photo texture for the
    #                              background (io/real_texture.py); None ->
    #                              procedural value noise
    bg_image_scale: float = 6.0  # world units per photo width

    GRID = 5

    @staticmethod
    def create(num_points: int = 600, seed: int = 7,
               extent=(6.0, 4.0, 3.0), center=(0.0, 0.0, 6.0)
               ) -> "SyntheticWorld":
        rng = np.random.default_rng(seed)
        pts = rng.uniform(-1.0, 1.0, size=(num_points, 3)) * np.asarray(extent)
        pts += np.asarray(center)
        inten = rng.uniform(150.0, 250.0, size=num_points)
        sizes = rng.uniform(8.0, 16.0, size=num_points)
        G = SyntheticWorld.GRID
        grid = (rng.random((num_points, G, G)) > 0.45).astype(np.float32)
        # keep the center cell bright so the 3D point itself is on texture
        grid[:, G // 2, G // 2] = 1.0
        return SyntheticWorld(pts.astype(np.float32),
                              inten.astype(np.float32),
                              sizes.astype(np.float32),
                              grid)

    @staticmethod
    def create_ring(num_points: int = 900, seed: int = 7,
                    r_in: float = 6.0, r_out: float = 9.0,
                    height: float = 3.0) -> "SyntheticWorld":
        """Points in an annulus around the origin with patch normals facing
        inward — a 'room wall' a loop trajectory can circle inside.  Only a
        sector is visible from any one view pose, so opposite sides of the
        loop are non-covisible (the loop-closure precondition)."""
        rng = np.random.default_rng(seed)
        ang = rng.uniform(0.0, 2 * np.pi, num_points)
        rad = rng.uniform(r_in, r_out, num_points)
        pts = np.stack([rad * np.cos(ang),
                        rng.uniform(-height, height, num_points),
                        rad * np.sin(ang)], -1)
        normals = -np.stack([np.cos(ang), np.zeros(num_points),
                             np.sin(ang)], -1)
        inten = rng.uniform(150.0, 250.0, size=num_points)
        sizes = rng.uniform(8.0, 16.0, size=num_points)
        G = SyntheticWorld.GRID
        grid = (rng.random((num_points, G, G)) > 0.45).astype(np.float32)
        grid[:, G // 2, G // 2] = 1.0
        return SyntheticWorld(pts.astype(np.float32),
                              inten.astype(np.float32),
                              sizes.astype(np.float32),
                              grid, normals.astype(np.float32),
                              bg="cylinder", bg_radius=r_out + 2.0)

    @staticmethod
    def create_planar(num_points: int = 500, seed: int = 7,
                      extent=(6.0, 4.0), depth: float = 6.0
                      ) -> "SyntheticWorld":
        """All points on one fronto-parallel wall plane z=depth — the
        degenerate configuration for the 8-point essential matrix (the
        reason the reference grafts Nistér 5-point,
        Tracking/ComputeEssential.cpp:1-10)."""
        rng = np.random.default_rng(seed)
        pts = np.stack([rng.uniform(-extent[0], extent[0], num_points),
                        rng.uniform(-extent[1], extent[1], num_points),
                        np.full(num_points, depth)], -1)
        inten = rng.uniform(150.0, 250.0, size=num_points)
        sizes = rng.uniform(8.0, 16.0, size=num_points)
        G = SyntheticWorld.GRID
        grid = (rng.random((num_points, G, G)) > 0.45).astype(np.float32)
        grid[:, G // 2, G // 2] = 1.0
        return SyntheticWorld(pts.astype(np.float32),
                              inten.astype(np.float32),
                              sizes.astype(np.float32),
                              grid)

    def render(self, cal: CameraCalibration, pose7: np.ndarray,
               noise: float = 1.0, seed: int = 0,
               bg_depth: float = 30.0, return_depth: bool = False):
        """Render the world from a view pose as (H, W) float32.

        The background is a textured plane at world z = bg_depth so that
        descriptor patches see geometrically consistent context (pure
        sensor noise would make BRIEF bits random); splats overlay it.
        """
        h, w = cal.height, cal.width
        rng = np.random.default_rng(seed)

        q = np.asarray(pose7[:4], np.float64)
        t = np.asarray(pose7[4:], np.float64)
        R = _quat_to_mat_np(q)

        # background surface: cast rays to it, sample procedural texture
        fx, fy = float(cal.fx), float(cal.fy)
        cx, cy = float(cal.cx), float(cal.cy)
        vv, uu = np.mgrid[0:h, 0:w]
        rays = np.stack([(uu - cx) / fx, (vv - cy) / fy,
                         np.ones_like(uu, np.float64)], -1)
        rays_w = rays @ R  # R^T applied row-wise
        c = -R.T @ t
        if self.bg == "cylinder":
            # vertical cylinder |x,z| = bg_radius around the origin: the
            # view-consistent backdrop for 360-degree loop trajectories
            # (a plane is only consistent when viewing roughly along +z)
            Rcyl = float(self.bg_radius)
            dx, dz = rays_w[..., 0], rays_w[..., 2]
            a = dx * dx + dz * dz
            b = 2.0 * (c[0] * dx + c[2] * dz)
            cc = c[0] * c[0] + c[2] * c[2] - Rcyl * Rcyl
            disc = np.maximum(b * b - 4 * a * cc, 0.0)
            tt = (-b + np.sqrt(disc)) / np.maximum(2 * a, 1e-9)
            hx = c[0] + tt * dx
            hz = c[2] + tt * dz
            px = np.arctan2(hz, hx) * Rcyl  # unrolled azimuth
            py = c[1] + tt * rays_w[..., 1]
        else:
            tt = (bg_depth - c[2]) / np.maximum(rays_w[..., 2], 1e-6)
            px = c[0] + tt * rays_w[..., 0]
            py = c[1] + tt * rays_w[..., 1]
        if self.bg_image is not None:
            # real-photo background: mirrored-tile bilinear sample over
            # world coords — real image statistics for FAST/BRIEF
            th, tw = self.bg_image.shape
            sx = (px / self.bg_image_scale) * tw
            sy = (py / self.bg_image_scale) * tw * (th / tw)
            # mirror-tile
            def _mirror(v, n):
                v = np.mod(v, 2 * n)
                return np.where(v < n, v, 2 * n - 1e-3 - v)
            gx = _mirror(sx, tw - 1)
            gy = _mirror(sy, th - 1)
            x0 = np.floor(gx).astype(int)
            y0 = np.floor(gy).astype(int)
            x1 = np.minimum(x0 + 1, tw - 1)
            y1 = np.minimum(y0 + 1, th - 1)
            wx = (gx - x0).astype(np.float32)
            wy = (gy - y0).astype(np.float32)
            tex = self.bg_image
            img = (tex[y0, x0] * (1 - wx) * (1 - wy)
                   + tex[y0, x1] * wx * (1 - wy)
                   + tex[y1, x0] * (1 - wx) * wy
                   + tex[y1, x1] * wx * wy)
            img = img.astype(np.float32)
        else:
            img = _surface_texture(px, py)
        img += rng.normal(0.0, noise, size=(h, w)).astype(np.float32)
        # camera-frame depth: rays have z=1 in camera coords, so depth=tt
        depth = tt.astype(np.float32)
        # splats are true world-space planar patches (normal +z, side
        # length = sizes/40 world units): every texture corner is a fixed
        # 3D point, so multi-view geometry is exact (billboards would
        # inject systematic parallax error).  Render far-to-near so nearer
        # patches occlude.
        xc = self.points @ R.T + t
        z = xc[:, 2]
        vis = z > 0.25
        u = fx * xc[:, 0] / np.maximum(z, 1e-6) + cx
        v = fy * xc[:, 1] / np.maximum(z, 1e-6) + cy
        vis &= (u > -40) & (u < w + 40) & (v > -40) & (v < h + 40)
        side = self.sizes / 40.0           # world half-side
        G = SyntheticWorld.GRID

        # per-point patch frame (e1, e2, n); default n=+z reproduces the
        # original axis-aligned-plane math exactly
        if self.normals is None:
            normals = np.broadcast_to(np.array([0.0, 0.0, 1.0]),
                                      self.points.shape)
        else:
            normals = self.normals
        order = np.argsort(-z)  # far first
        for i in order:
            if not vis[i]:
                continue
            pz = self.points[i].astype(np.float64)
            s_half = side[i]
            n = normals[i].astype(np.float64)
            n = n / np.linalg.norm(n)
            up_ref = np.array([0.0, 1.0, 0.0]) \
                if abs(n[1]) < 0.9 else np.array([1.0, 0.0, 0.0])
            e1 = np.cross(up_ref, n)
            e1 /= np.linalg.norm(e1)
            e2 = np.cross(n, e1)
            # project the 4 patch corners for the pixel bounding box
            corners = pz[None, :] + s_half * np.array(
                [[-1, -1], [1, -1], [-1, 1], [1, 1]]) @ np.stack([e1, e2])
            ccam = corners @ R.T + t
            if np.any(ccam[:, 2] < 0.2):
                continue
            cu = fx * ccam[:, 0] / ccam[:, 2] + cx
            cv = fy * ccam[:, 1] / ccam[:, 2] + cy
            xs0, xs1 = max(int(np.floor(cu.min())), 0), \
                min(int(np.ceil(cu.max())) + 1, w)
            ys0, ys1 = max(int(np.floor(cv.min())), 0), \
                min(int(np.ceil(cv.max())) + 1, h)
            if xs1 <= xs0 or ys1 <= ys0:
                continue
            # ray-plane intersection with the patch plane (pz, n)
            rw = rays_w[ys0:ys1, xs0:xs1]
            denom = rw @ n
            tt_i = np.dot(pz - c, n) / np.where(np.abs(denom) < 1e-9, 1e-9,
                                                denom)
            X = c[None, None, :] + tt_i[..., None] * rw
            dX = X - pz
            un = (dX @ e1) / (2 * s_half) + 0.5
            vn = (dX @ e2) / (2 * s_half) + 0.5
            inside = (un >= 0) & (un < 1) & (vn >= 0) & (vn < 1) & (tt_i > 0)
            if not inside.any():
                continue
            # bilinear texture sample: smooth intensity gradients inside
            # the patch, like real image patches — nearest-neighbor binary
            # cells made BRIEF bits flip catastrophically under viewpoint
            # warp (0% gt-consistent brute-force matches at 16 frames
            # separation), which real ORB imagery does not do
            gx = np.clip(un * G - 0.5, 0.0, G - 1.000001)
            gy = np.clip(vn * G - 0.5, 0.0, G - 1.000001)
            g0x, g0y = np.floor(gx).astype(int), np.floor(gy).astype(int)
            g1x = np.minimum(g0x + 1, G - 1)
            g1y = np.minimum(g0y + 1, G - 1)
            wx, wy = gx - g0x, gy - g0y
            tg = self.tex_grid[i]
            cell = (tg[g0y, g0x] * (1 - wx) * (1 - wy)
                    + tg[g0y, g1x] * wx * (1 - wy)
                    + tg[g1y, g0x] * (1 - wx) * wy
                    + tg[g1y, g1x] * wx * wy)
            tex = self.intensities[i] * (0.12 + 0.88 * cell)
            patch = img[ys0:ys1, xs0:xs1]
            img[ys0:ys1, xs0:xs1] = np.where(inside, tex, patch)
            depth[ys0:ys1, xs0:xs1] = np.where(
                inside, tt_i.astype(np.float32), depth[ys0:ys1, xs0:xs1])
        if return_depth:
            return np.clip(img, 0.0, 255.0), depth
        return np.clip(img, 0.0, 255.0)


def default_calibration(width: int = 320, height: int = 180
                        ) -> CameraCalibration:
    f = 0.85 * width
    return CameraCalibration.pinhole(f, f, width / 2.0, height / 2.0,
                                     width, height)


def orbit_trajectory(num_frames: int, radius: float = 0.8,
                     forward: float = 0.012,
                     look_at=(0.0, 0.0, 6.0),
                     sweep: float = 0.35) -> np.ndarray:
    """(T, 7) view poses: gentle lateral arc with forward drift, always
    looking roughly at the cloud center — plenty of parallax for init."""
    poses = []
    target = np.asarray(look_at, np.float64)
    for i in range(num_frames):
        ang = sweep * np.sin(2 * np.pi * i / max(num_frames - 1, 1) * 0.5)
        c = np.array([radius * np.sin(ang), 0.25 * np.sin(ang * 2.0),
                      forward * i])
        fwd = target - c
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        upv = np.cross(fwd, right)
        # camera-from-world rotation: rows are camera axes
        Rcw = np.stack([right, upv, fwd])
        t = -Rcw @ c
        q = _mat_to_quat_np(Rcw)
        poses.append(np.concatenate([q, t]))
    return np.asarray(poses, np.float32)


def loop_trajectory(num_frames: int, radius: float = 3.0,
                    fraction: float = 1.12, bob: float = 0.08,
                    look_ahead: float = 0.55) -> np.ndarray:
    """(T, 7) view poses circling the origin (inside a ring world), facing
    mostly tangent (slightly toward the wall ahead).  ``fraction`` > 1
    re-visits the start sector after a full revolution — the classic
    loop-closure trajectory.  ``bob`` adds gentle vertical motion so
    triangulation sees vertical parallax too."""
    poses = []
    for i in range(num_frames):
        th = 2 * np.pi * fraction * i / max(num_frames - 1, 1)
        c = np.array([radius * np.cos(th),
                      bob * np.sin(3.0 * th),
                      radius * np.sin(th)])
        tangent = np.array([-np.sin(th), 0.0, np.cos(th)])
        outward = np.array([np.cos(th), 0.0, np.sin(th)])
        fwd = tangent + look_ahead * outward
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        upv = np.cross(fwd, right)
        Rcw = np.stack([right, upv, fwd])
        t = -Rcw @ c
        q = _mat_to_quat_np(Rcw)
        poses.append(np.concatenate([q, t]))
    return np.asarray(poses, np.float32)


def occlusion_frame(cal: CameraCalibration, seed: int = 0,
                    level: float = 30.0) -> np.ndarray:
    """A featureless 'lens covered' frame (uniform + sensor noise): the
    frontend finds ~no corners, so tracking fails — the stimulus for the
    SKIPPED -> RELOCALIZING failure path (Runtime.cpp:271-301)."""
    rng = np.random.default_rng(seed)
    img = np.full((cal.height, cal.width), level, np.float32)
    img += rng.normal(0.0, 1.5, size=img.shape).astype(np.float32)
    return np.clip(img, 0.0, 255.0)


def render_sequence(world: SyntheticWorld, cal: CameraCalibration,
                    poses: np.ndarray, noise: float = 2.0):
    """Yields (frame_idx, image, gt_pose7)."""
    for i, p in enumerate(poses):
        yield i, world.render(cal, p, noise=noise, seed=100 + i), p


# the session seed (``SlamFleet(seed=)``) of the fleet drives on
# ``fleet_frames``'s worlds, the same in the JAX package's stored drives
FLEET_SEED = 3


def fleet_frames(n: int, num_frames: int):
    """(num_frames, n, 180, 320) frames of ``n`` distinct worlds, one per
    fleet stream, and the rendering calibration: the worlds of the JAX
    package's fleet test (``SyntheticWorld.create(450, seed=20 + i)``,
    ``orbit_trajectory(num_frames, radius=2.0, forward=0.01,
    sweep=0.5 + 0.05 * i)``, frame ``f`` of stream ``i`` rendered with
    seed ``1000 + 100 i + f``)."""
    cal = default_calibration()
    worlds = [SyntheticWorld.create(450, seed=20 + i) for i in range(n)]
    trajs = [orbit_trajectory(num_frames, radius=2.0, forward=0.01,
                              sweep=0.5 + 0.05 * i) for i in range(n)]
    imgs = np.stack([np.stack([worlds[i].render(cal, trajs[i][f],
                                                seed=1000 + i * 100 + f)
                               for i in range(n)])
                     for f in range(num_frames)])
    return imgs, cal


def frame_crcs(imgs: np.ndarray) -> np.ndarray:
    """CRC-32 of each stream's frames of ``fleet_frames``, in frame
    order."""
    return np.array([zlib.crc32(np.ascontiguousarray(imgs[:, i]).tobytes())
                     for i in range(imgs.shape[1])], np.int64)
