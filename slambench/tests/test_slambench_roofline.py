"""The FAST kernel's operations and bytes at 180x320, worked by hand."""

import torch

from slambench import roofline

H, W = 180, 320
# interior pixels 174 x 314, each through the 48-operation early-out test,
# and every pixel through NMS (10) and the two 7-tap blur passes (26)
FLAT_OPS = 174 * 314 * 48 + 180 * 320 * 36


def test_flat_frame():
    img = torch.full((H, W), 100.0)
    assert roofline.candidates(img, 10.0) == 0
    assert roofline.work(H, W, 0) == (FLAT_OPS, 691_200)
    # 691200 B at 3.35e12 B/s: 0.206 us; 4696128 ops at 33.5e12/s: 0.140
    assert abs(roofline.least_seconds(H, W, 0) - 691_200 / 3.35e12) < 1e-15


def test_one_bright_pixel():
    """A lone bright pixel is a dark-ring candidate of its own; the pixels
    around it see one bright ring pixel, which no antipodal pair passes."""
    img = torch.zeros((H, W))
    img[50, 60] = 100.0
    assert roofline.candidates(img, 10.0) == 1
    assert roofline.work(H, W, 1)[0] == FLAT_OPS + 82


def test_bound_by_operations_on_noise():
    g = torch.Generator().manual_seed(0)
    img = 255.0 * torch.rand((H, W), generator=g)
    scans = roofline.candidates(img, 10.0)
    ops, nbytes = roofline.work(H, W, scans)
    assert ops / roofline.OPS_PER_S > nbytes / roofline.BYTES_PER_S
