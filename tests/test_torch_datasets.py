"""The port's dataset loaders and frame pump against the JAX package's.

- ``load_dataset`` / ``load_euroc`` / ``load_tum_rgbd`` on the temporary
  layouts of ``tests/test_datasets.py``, a flat directory, and the
  vendored ``mini_seq`` and ``ring_seq``: every field of the
  ``DatasetSequence`` exact, ``tracking_calibration`` exact in float32,
  ``gt_for_frames`` exact; ``mini_seq``'s fields also against those
  stored by ``tools/make_torch_dataset_fixture.py``.  The port parses
  ``sensor.yaml`` with its subset reader only; the JAX loader here uses
  PyYAML.
- The frame pump on both routes (the C++ library built from
  ``native/frame_pump.cpp``, and the Python PNG reader): decode exact
  against the JAX package's ``read_image_gray``, resize within 1e-3 grey
  levels, every PNG filter type, ordered iteration past a bad file, and a
  failed build that names the Python route and keeps the compiler's
  message.
"""

import logging
import os
import shutil
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import yaml

from mageslam_tpu.io import datasets as jds
from mageslam_tpu.io import native_loader as jnl
from mageslam_tpu_torch.io import datasets as tds
from mageslam_tpu_torch.io import native_loader as tnl
from test_datasets import _png, euroc_dir, tum_dir  # noqa: F401
from test_torch_device_io import DATASET, assert_same_calibration

DATA = Path(__file__).resolve().parent / "data"
ROOT = DATA.parent.parent


@pytest.fixture(scope="module")
def ds():
    return np.load(DATASET)


def assert_same_sequence(t, j):
    assert t.name == j.name and t.image_paths == j.image_paths
    np.testing.assert_array_equal(t.timestamps, j.timestamps)
    assert_same_calibration(t.calibration, j.calibration)
    for f in ("gt_timestamps", "gt_view_poses"):
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
            assert a.dtype == b.dtype, f
    assert (t.imu is None) == (j.imu is None)
    if t.imu is not None:
        for a, b in zip(t.imu, j.imu):
            np.testing.assert_array_equal(a, b)
    for w in (320, 160):
        assert_same_calibration(t.tracking_calibration(w),
                                j.tracking_calibration(w))
    gt_t, gt_j = t.gt_for_frames(), j.gt_for_frames()
    assert (gt_t is None) == (gt_j is None)
    if gt_t is not None:
        np.testing.assert_array_equal(gt_t, gt_j)


@pytest.mark.parametrize("layout", ["euroc", "tum", "flat", "mini_seq",
                                    "ring_seq"])
def test_loaders_match_jax(layout, euroc_dir, tum_dir, tmp_path):  # noqa
    if layout == "flat":
        root = tmp_path / "flat"
        root.mkdir()
        for i in range(2):
            _png(root / f"img_{i}.png", seed=i)
    else:
        root = {"euroc": euroc_dir, "tum": tum_dir}.get(layout,
                                                        DATA / layout)
    assert_same_sequence(tds.load_dataset(str(root)),
                         jds.load_dataset(str(root)))
    if layout == "euroc":
        assert_same_sequence(tds.load_euroc(str(root), max_frames=2),
                             jds.load_euroc(str(root), max_frames=2))
    if layout == "tum":
        assert_same_sequence(tds.load_tum_rgbd(str(root)),
                             jds.load_tum_rgbd(str(root)))


def test_mini_seq_matches_stored_fields(ds):
    seq = tds.load_dataset(str(DATA / "mini_seq"))
    assert seq.name == str(ds["seq_name"])
    assert [str(Path(p).relative_to(ROOT)) for p in seq.image_paths] \
        == ds["seq_paths"].tolist()
    np.testing.assert_array_equal(seq.timestamps, ds["seq_timestamps"])
    np.testing.assert_array_equal(seq.gt_view_poses, ds["seq_gt_poses"])
    np.testing.assert_array_equal(seq.gt_for_frames(),
                                  ds["seq_gt_for_frames"])
    for cal, key in ((seq.calibration, "seq_cal"),
                     (seq.tracking_calibration(320), "seq_tracking")):
        np.testing.assert_array_equal(
            [cal.fx, cal.fy, cal.cx, cal.cy, cal.width, cal.height],
            ds[key])
        np.testing.assert_array_equal(cal.dist.numpy(), ds[f"{key}_dist"])
        assert cal.model == int(ds[f"{key}_model"])


def test_subset_yaml_reader_matches_pyyaml(euroc_dir):  # noqa: F811
    for path in (euroc_dir / "mav0" / "cam0" / "sensor.yaml",
                 DATA / "mini_seq" / "mav0" / "cam0" / "sensor.yaml",
                 DATA / "ring_seq" / "mav0" / "cam0" / "sensor.yaml"):
        got, want = tds._read_yaml(path), yaml.safe_load(path.read_text())
        for key in ("intrinsics", "resolution", "distortion_coefficients"):
            assert got[key] == [float(v) for v in want[key]], key


# ---------------------------------------------------------------------------
# the frame pump

@pytest.fixture(params=["native", "python"])
def route(request, monkeypatch):
    if request.param == "python":
        monkeypatch.setattr(tnl, "_lib", None)
        monkeypatch.setattr(tnl, "_tried", True)
    else:
        assert tnl.load_library() is not None, tnl.build_error
    assert tnl.backend() == request.param
    return request.param


def png_with_filters(path: Path, img: np.ndarray) -> None:
    """An 8-bit PNG whose rows cycle through the five filter types."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    px = img.reshape(h, w * ch).astype(np.int64)
    rows = []
    for y in range(h):
        ftype, cur = y % 5, px[y]
        up = px[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(ch, np.int64), cur[:-ch]])
        ul = np.concatenate([np.zeros(ch, np.int64), up[:-ch]])
        if ftype == 4:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        else:
            pred = (0 * cur, left, up, (left + up) >> 1)[ftype]
        rows.append(bytes([ftype]) + ((cur - pred) & 0xFF)
                    .astype(np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(b"".join(rows)))
        + chunk(b"IEND", b""))


def test_decode_matches_jax(route):
    paths = sorted((DATA / "mini_seq" / "mav0" / "cam0" / "data")
                   .glob("*.png"))
    for p in paths[:12]:
        want = jnl.read_image_gray(str(p), 320, 180)
        np.testing.assert_array_equal(tnl.read_image_gray(str(p), 320, 180),
                                      want)
        for w, h in ((160, 90), (501, 287)):
            np.testing.assert_allclose(
                tnl.read_image_gray(str(p), w, h),
                jnl.read_image_gray(str(p), w, h), rtol=0, atol=1e-3)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_every_png_filter(route, channels, tmp_path):
    rng = np.random.default_rng(channels)
    shape = (23, 31) if channels == 1 else (23, 31, channels)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    img[5:9, 4:12] = 77              # grey pixels in colour images
    path = tmp_path / "f.png"
    png_with_filters(path, img)
    got = tnl.read_image_gray(str(path), 31, 23)
    np.testing.assert_array_equal(got, jnl.read_image_gray(str(path), 31,
                                                           23))
    if channels <= 2:
        np.testing.assert_array_equal(got, img if channels == 1
                                      else img[..., 0])


def test_pump_order_and_bad_files(route, tmp_path):
    rng = np.random.default_rng(0)
    paths, want = [], []
    for i in range(9):
        img = rng.integers(0, 256, (24, 32)).astype(np.uint8)
        p = tmp_path / f"f{i}.png"
        png_with_filters(p, img)
        paths.append(str(p))
        want.append(img.astype(np.float32))
    (tmp_path / "bad.png").write_bytes(b"not an image")
    paths.insert(4, str(tmp_path / "bad.png"))
    pump = tnl.FramePump(paths, 32, 24, capacity=3, n_threads=3)
    assert pump.backend == route
    got = list(pump)
    assert [i for i, _ in got] == [i for i in range(10) if i != 4]
    for (_, frame), img in zip(got, want):
        np.testing.assert_array_equal(frame, img)
    assert pump.decode_errors() == 1
    pump.close()
    assert tnl.image_size(paths[0]) == (32, 24)


def test_failed_build_names_the_python_route(monkeypatch, tmp_path, caplog):
    bad = tmp_path / "frame_pump.cpp"
    bad.write_text("#include <no_such_header.h>\n")
    monkeypatch.setattr(tnl, "SOURCE", bad)
    monkeypatch.setattr(tnl, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tnl, "_lib", None)
    monkeypatch.setattr(tnl, "_tried", False)
    monkeypatch.setattr(tnl, "build_error", None)
    with caplog.at_level(logging.WARNING, logger=tnl.__name__):
        assert tnl.backend() == "python"
    assert "no_such_header" in tnl.build_error
    assert "no_such_header" in caplog.text
    p = sorted((DATA / "mini_seq" / "mav0" / "cam0" / "data")
               .glob("*.png"))[0]
    assert tnl.FramePump([str(p)], 320, 180).backend == "python"


def test_prebuilt_library_is_not_loaded():
    lib = tnl.load_library()
    assert lib is not None, tnl.build_error
    assert Path(lib._name).parent == tnl.BUILD_DIR
    assert os.path.basename(lib._name) != "libmageslam_io.so"


def test_library_of_another_host_is_not_loaded(monkeypatch, tmp_path):
    own = tnl.load_library()
    assert own is not None, tnl.build_error
    monkeypatch.setattr(tnl, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnl, "_lib", None)
    monkeypatch.setattr(tnl, "_tried", False)
    monkeypatch.setattr(tnl, "_host", "another compiler\nanother host")
    foreign = tnl.library_path()
    foreign.write_bytes(b"linked elsewhere")    # CDLL would raise on it
    monkeypatch.setattr(tnl, "_host", None)
    assert tnl.library_path() != foreign
    shutil.copy(own._name, tnl.library_path())
    assert tnl.backend() == "native"
    assert Path(tnl._lib._name) == tnl.library_path()
    assert foreign.read_bytes() == b"linked elsewhere"


def test_stale_library_under_this_key_is_built_anew(monkeypatch, tmp_path):
    monkeypatch.setattr(tnl, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnl, "_lib", None)
    monkeypatch.setattr(tnl, "_tried", False)
    monkeypatch.setattr(tnl, "build_error", None)
    tnl.library_path().write_bytes(b"truncated")
    assert tnl.backend() == "native", tnl.build_error
    assert Path(tnl._lib._name) == tnl.library_path()
    assert tnl.library_path().read_bytes()[:4] == b"\x7fELF"
