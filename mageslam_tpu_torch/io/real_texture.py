"""Real-photograph-textured evaluation worlds.

A copy of ``mageslam_tpu/io/real_texture.py`` (numpy only) over the port's
``io/synthetic.py``: the same seeds give the same worlds, array for array.
The geometry is synthetic, so the ground truth is exact, and the texture is
a real photograph, matplotlib's bundled ``grace_hopper.jpg``, so the
frontend sees natural gradients and realistic FAST corner populations.
Splat patches are crops of the photo; the background is the photo tiled
with mirroring.

These worlds feed ``tools/make_dataset_torch.py``, which renders an
EuRoC-format sequence for ``io/datasets.py``.  matplotlib (for the photo)
and PIL (to decode it) are imported only when a world is built; where
either is missing, building one raises ``ImportError``.
"""

from __future__ import annotations

import os

import numpy as np

from mageslam_tpu_torch.io.synthetic import SyntheticWorld


def load_reference_photo() -> np.ndarray:
    """(H, W) float32 grayscale real photograph from matplotlib's bundled
    sample data (no network required)."""
    try:
        import matplotlib
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "real-texture worlds need matplotlib (for its bundled "
            "grace_hopper.jpg) and PIL; this interpreter lacks "
            f"{e.name or e}") from e
    path = os.path.join(os.path.dirname(matplotlib.__file__), "mpl-data",
                        "sample_data", "grace_hopper.jpg")
    img = Image.open(path).convert("L")
    return np.asarray(img, np.float32)


def _photo_patches(photo: np.ndarray, n: int, grid: int,
                   rng: np.random.Generator) -> np.ndarray:
    """(n, grid, grid) normalized [0,1] crops, bilinearly downsampled from
    random photo locations — real micro-texture for each splat."""
    h, w = photo.shape
    out = np.zeros((n, grid, grid), np.float32)
    for i in range(n):
        size = int(rng.uniform(24, 64))
        y0 = rng.integers(0, h - size)
        x0 = rng.integers(0, w - size)
        crop = photo[y0:y0 + size, x0:x0 + size]
        ys = np.linspace(0, size - 1, grid)
        xs = np.linspace(0, size - 1, grid)
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        y_i, x_i = gy.astype(int), gx.astype(int)
        out[i] = crop[y_i, x_i]
        lo, hi = out[i].min(), out[i].max()
        out[i] = (out[i] - lo) / max(hi - lo, 1.0)
    return out


def create_real_ring(num_points: int = 900, seed: int = 7,
                     r_in: float = 6.0, r_out: float = 9.0,
                     height: float = 3.0) -> SyntheticWorld:
    """Ring world (loop-closure geometry) with real-photo texture."""
    rng = np.random.default_rng(seed)
    photo = load_reference_photo()
    w = SyntheticWorld.create_ring(num_points, seed=seed, r_in=r_in,
                                   r_out=r_out, height=height)
    return SyntheticWorld(
        points=w.points, intensities=w.intensities, sizes=w.sizes,
        tex_grid=_photo_patches(photo, num_points, SyntheticWorld.GRID,
                                rng),
        normals=w.normals, bg=w.bg, bg_radius=w.bg_radius,
        bg_image=photo, bg_image_scale=8.0)


def create_real_cloud(num_points: int = 700, seed: int = 3,
                      extent=(6.0, 4.0, 3.0),
                      center=(0.0, 0.0, 6.0)) -> SyntheticWorld:
    """Volumetric cloud world (orbit geometry) with real-photo texture."""
    rng = np.random.default_rng(seed)
    photo = load_reference_photo()
    w = SyntheticWorld.create(num_points, seed=seed, extent=extent,
                              center=center)
    return SyntheticWorld(
        points=w.points, intensities=w.intensities, sizes=w.sizes,
        tex_grid=_photo_patches(photo, num_points, SyntheticWorld.GRID,
                                rng),
        normals=w.normals, bg=w.bg, bg_radius=w.bg_radius,
        bg_image=photo, bg_image_scale=10.0)
