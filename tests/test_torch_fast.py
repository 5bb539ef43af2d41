"""FAST + NMS + blur: the port's plain versions and its CUDA kernel against
the JAX package (``ops/fast.py`` and the Pallas kernels of
``ops/fast_pallas.py`` in interpret mode).

Tolerances: the NMS'd score uses only subtraction, min and max, so it must
be bit-exact everywhere.  The blur is float32 multiply-adds in another
association order than ``pyramid.gaussian_blur`` (an XLA convolution), so
it is held to 2e-3 against it and to 5e-3 against a float64 numpy blur
(the bounds of ``tests/test_fast_pallas.py``).  The CUDA kernel itself is
held against the plain version in ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mageslam_tpu.ops import fast as jfast
from mageslam_tpu.ops import fast_pallas as jpal
from mageslam_tpu.ops import pyramid as jpyr
from mageslam_tpu_torch.ops import fast, fast_cuda, pyramid

torch.set_num_threads(2)


def _images():
    rng = np.random.default_rng(42)
    noise = rng.uniform(0, 255, (64, 96)).astype(np.float32)
    sq = np.zeros((48, 64), np.float32)
    sq[12:30, 20:44] = 200.0
    sq += rng.normal(0, 2.0, sq.shape).astype(np.float32)
    return [(noise, 20.0), (sq, 15.0)]


def _f64_blur(img, taps):
    p = np.pad(img.astype(np.float64), 3, mode="reflect")
    hb = sum(taps[i] * p[:, i:i + img.shape[1]] for i in range(7))
    return sum(taps[j] * hb[j:j + img.shape[0], :] for j in range(7))


def test_gaussian_taps_bit_exact():
    np.testing.assert_array_equal(
        pyramid.gaussian_kernel1d(7).numpy(),
        np.asarray(jpyr.gaussian_kernel1d(7)))


@pytest.mark.parametrize("case", [0, 1])
def test_detect_matches_jnp_and_pallas(case):
    img, thr = _images()[case]
    ref = np.asarray(jfast.detect(jnp.asarray(img), thr))
    pal = np.asarray(jpal.detect(jnp.asarray(img), thr, interpret=True))
    got = fast.detect(torch.as_tensor(img), thr).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pal)
    assert (got > 0).sum() >= 4


@pytest.mark.parametrize("case", [0, 1])
def test_detect_and_smooth_matches_pallas(case):
    img, thr = _images()[case]
    s_pal, b_pal = jpal.detect_and_smooth(jnp.asarray(img), thr, 7,
                                          interpret=True)
    b_jnp = np.asarray(jpyr.gaussian_blur(jnp.asarray(img), 7))
    s, b = fast_cuda.detect_and_smooth(torch.as_tensor(img), thr, 7)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_pal))
    np.testing.assert_array_equal(
        s.numpy(), np.asarray(jfast.detect(jnp.asarray(img), thr)))
    np.testing.assert_allclose(b.numpy(), b_jnp, atol=2e-3)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_pal), atol=2e-3)
    gold = _f64_blur(img, np.asarray(jpyr.gaussian_kernel1d(7), np.float64))
    np.testing.assert_allclose(b.numpy(), gold, atol=5e-3)


def test_cpu_tensor_takes_the_plain_version():
    img, thr = _images()[0]
    before = fast_cuda.launch_counts()
    s = fast_cuda.detect(torch.as_tensor(img), thr)
    np.testing.assert_array_equal(s.numpy(),
                                  fast.detect(torch.as_tensor(img),
                                              thr).numpy())
    assert fast_cuda.launch_counts() == before


def test_score_patches_and_subpixel_exact():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (60, 80)).astype(np.float32)
    uv = np.stack([rng.integers(0, 80, 40), rng.integers(0, 60, 40)],
                  -1).astype(np.float32)
    ref = np.asarray(jfast.score_patches_at(jnp.asarray(img),
                                            jnp.asarray(uv), 12.0))
    got = fast.score_patches_at(torch.as_tensor(img), torch.as_tensor(uv),
                                12.0).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        fast.subpixel_offsets(torch.as_tensor(ref)).numpy(),
        np.asarray(jfast.subpixel_offsets(jnp.asarray(ref))))


# --- the kernel's early-out and score arithmetic, held on the CPU ---------

def _early_out_images():
    z = np.load(__file__.replace("test_torch_fast.py",
                                 "data/torch_orbit60.npz"))
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:72, 0:104]
    plateau = (((yy // 6) + (xx // 6)) % 2 * 160.0 + 30.0).astype(np.float32)
    plateau[20:40, 30:60] = 255.0            # a flat block: ties everywhere
    small = rng.integers(0, 4, (40, 56)).astype(np.float32) * 9.0
    return {
        "fixture frame": z["imgs"][7].astype(np.float32),
        "noise": rng.uniform(0, 255, (90, 130)).astype(np.float32),
        "plateaus and ties": plateau,
        "differences at the threshold": small,   # |c - center| in {0,9,18,27}
    }


def _kernel_score_arithmetic(img: torch.Tensor, thr: float) -> torch.Tensor:
    """The raw score as the CUDA kernel forms it: min and max over the raw
    ring values first (the dark polarity over the negated values), then the
    centre and the threshold subtracted once each, and only where the
    antipodal test passed."""
    h, w = img.shape
    p = torch.nn.functional.pad(img, (3, 3, 3, 3))
    c = torch.stack([p[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                     for dx, dy in fast.CIRCLE_OFFSETS])
    bright, dark = fast.antipodal_candidates(img, thr)
    zero = torch.zeros_like(img)
    sb = torch.where(bright, fast._arc_score(c, 0) - img - thr, zero)
    sd = torch.where(dark, fast._arc_score(-c, 0) - (-img) - thr, zero)
    return torch.maximum(torch.maximum(sb, sd), zero)


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """The kernel's order-preserving int32 key of float32 bits."""
    bits = x.contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def test_order_key_preserves_float_order():
    """The arc scan runs on integer keys: their signed order must be the
    float order, the map its own inverse, and the complement the order
    reversed (the dark polarity)."""
    rng = np.random.default_rng(9)
    x = torch.as_tensor(np.concatenate([
        rng.normal(0, 100, 4000), rng.uniform(0, 255, 4000).round(),
        [0.0, -0.0, 1e-40, -1e-40, 3.4e38, -3.4e38, np.inf, -np.inf],
    ]).astype(np.float32))
    k = _order_key(x)
    order = torch.argsort(k, stable=True)
    assert (x[order][1:] >= x[order][:-1]).all()
    lt = x[:, None] < x[None, :]
    assert (k[:, None] < k[None, :])[lt].all()
    assert torch.equal(_order_key(k.view(torch.float32)).view(torch.float32)
                       .view(torch.int32), x.view(torch.int32))
    assert torch.equal(~k < ~k[0], k > k[0])


@pytest.mark.parametrize("name", ["fixture frame", "noise",
                                  "plateaus and ties",
                                  "differences at the threshold"])
@pytest.mark.parametrize("thr", [0.0, 9.0, 10.0, 27.5])
def test_antipodal_early_out_is_exact(name, thr):
    """Every pixel the antipodal-pair test rejects has a plain raw score of
    exactly 0, per polarity; and the kernel's reordered arithmetic (min/max
    first, threshold once) gives the plain score bit for bit."""
    img = torch.as_tensor(_early_out_images()[name])
    h, w = img.shape
    bright, dark = fast.antipodal_candidates(img, thr)
    p = torch.nn.functional.pad(img, (3, 3, 3, 3))
    circle = torch.stack([p[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                          for dx, dy in fast.CIRCLE_OFFSETS])
    interior = torch.zeros_like(bright)
    interior[3:h - 3, 3:w - 3] = True
    arc_b = fast._arc_score(circle - img[None] - thr, 0)
    arc_d = fast._arc_score(img[None] - circle - thr, 0)
    assert not (arc_b[interior & ~bright] > 0).any()
    assert not (arc_d[interior & ~dark] > 0).any()
    raw = fast.fast_score_map(img, thr)
    assert not raw[~(bright | dark)].any()
    assert not (bright | dark)[~interior].any()
    kernel = _kernel_score_arithmetic(img, thr)
    assert torch.equal(kernel, raw)
    assert torch.equal(fast.nms3x3(kernel), fast.detect(img, thr))
    if name != "differences at the threshold" and thr >= 9.0 and thr < 20:
        # the test is a filter, not a pass-through
        assert (bright | dark).any() and raw.any()
        assert ((bright | dark) & (raw == 0)).any() or name == "noise"
