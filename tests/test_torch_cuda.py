"""The hand-written CUDA FAST kernel against its plain PyTorch version,
and the parallel layer's distributed BA on the card.

These tests need an NVIDIA GPU and skip without one.  They import neither
JAX nor ``tests/conftest.py``'s JAX set-up, so they run on a GPU host that
has no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: the NMS'd score uses only subtraction, min and max, so the
kernel must equal the plain version bit for bit.  The kernel's blur adds
the taps in the plain version's order without FMA contraction; it is held
to 2e-3, the blur bound of the JAX package's own kernel test.

The kernel works on 32x16 tiles, takes a 16-byte path where the row length
is a multiple of four and the pointers are aligned, and skips the arc scan
for pixels that fail an exact antipodal-pair test; the cases below cover
both sides of each of those choices.

The library's name and its build (``fast_cuda.library_path``, ``load``)
are tested here on the CPU as well, with a stand-in ``nvcc`` that links a
stub of the kernel's C interface with the host's C compiler.
"""

import os
import shutil
import stat
from pathlib import Path

import numpy as np
import pytest
import torch

from mageslam_tpu_torch.ops import fast, fast_cuda

BLUR_ATOL = 2e-3


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _noise(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(0, 255, shape).astype(np.float32))


def _cuda_image(shape, seed):
    _need_card()
    return _noise(shape, seed).cuda()


def _assert_matches_plain(img, ksize=7, threshold=10.0):
    ks, kb = fast_cuda.detect_and_smooth(img, threshold, ksize)
    kd = fast_cuda.detect(img, threshold)
    ps, pb = fast.detect_and_smooth(img.contiguous(), threshold, ksize)
    torch.cuda.synchronize()
    assert ks.shape == kb.shape == kd.shape == img.shape
    assert torch.equal(ks, ps) and torch.equal(kd, ps)
    assert float((kb - pb).abs().max()) <= BLUR_ATOL
    return ps


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (180, 320), (480, 752), (37, 61),
    (50, 97), (33, 130),        # W % 4 != 0, ragged last tiles
    (9, 21), (7, 7), (16, 32),  # below or exactly one tile
    (5, 40),                    # no interior pixel at all
    (120, 213), (80, 142),      # pyramid levels of 180x320 at scale 1.5
    (320, 501), (213, 334),     # and of 480x752
])
def test_cuda_kernel_matches_plain(shape):
    img = _cuda_image(shape, 11)
    n0 = fast_cuda.launch_counts()
    _assert_matches_plain(img)
    n1 = fast_cuda.launch_counts()
    assert n1["fast_detect_and_smooth"] == n0["fast_detect_and_smooth"] + 1
    assert n1["fast_detect"] == n0["fast_detect"] + 1


def _patterns(name):
    if name == "constant":              # nothing survives the early-out
        return torch.full((64, 96), 128.0)
    if name == "checkerboard":          # every pixel is a candidate
        yy, xx = torch.meshgrid(torch.arange(64), torch.arange(96),
                                indexing="ij")
        return ((yy + xx) % 2).to(torch.float32) * 200.0
    if name == "blocks":                # plateaus: ties in the NMS
        img = torch.full((80, 128), 20.0)
        img[16:48, 24:72] = 200.0
        img[30:66, 90:120] = 120.0
        return img
    if name == "sparse":                # a few bright dots on black
        img = torch.zeros((96, 160))
        img[10::17, 7::23] = 250.0
        return img
    raise ValueError(name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["constant", "checkerboard", "blocks",
                                  "sparse"])
def test_cuda_kernel_on_patterns(name):
    _need_card()
    ps = _assert_matches_plain(_patterns(name).cuda())
    if name == "constant":
        assert not ps.any()
    if name in ("blocks", "sparse"):
        assert ps.any()


@pytest.mark.cuda
@pytest.mark.parametrize("ksize", [1, 3, 5, 7])
def test_cuda_kernel_blur_sizes(ksize):
    _assert_matches_plain(_cuda_image((90, 124), 13), ksize=ksize)
    _assert_matches_plain(_cuda_image((41, 67), 14), ksize=ksize)


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [0.0, 3.5, 40.0])
def test_cuda_kernel_thresholds(threshold):
    _assert_matches_plain(_cuda_image((75, 140), 15), threshold=threshold)


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["rows", "columns", "strided", "offset"])
def test_cuda_kernel_takes_views(view):
    """Non-contiguous inputs are copied; a contiguous view at an odd offset
    is not 16-byte aligned and takes the scalar path."""
    big = _cuda_image((120, 203), 16)
    img = {"rows": big[7:103],               # contiguous, W % 4 != 0
           "columns": big[:, 5:165],         # non-contiguous
           "strided": big[::2, ::3],         # non-contiguous
           "offset": big.flatten()[3:3 + 90 * 128].view(90, 128),
           }[view]
    if view == "offset":
        assert img.is_contiguous() and img.data_ptr() % 16 != 0
    _assert_matches_plain(img)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_a_batch():
    img = _cuda_image((2, 180, 320), 12)
    with pytest.raises(ValueError):
        fast_cuda.detect_and_smooth(img, 10.0, 7)


@pytest.mark.cuda
def test_cuda_multilevel_frontend_matches_cpu():
    """Three pyramid levels of a textured frame on the card: one launch per
    level, and the keypoints, responses and levels of the CPU's plain run."""
    _need_card()
    from mageslam_tpu_torch.geometry.camera import CameraCalibration
    from mageslam_tpu_torch.tracking import frontend
    yy, xx = np.mgrid[0:180, 0:320]
    rng = np.random.default_rng(5)
    img = (128 + 60 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
           + rng.normal(0, 8, (180, 320))).astype(np.float32)
    cal = CameraCalibration.pinhole(272.0, 272.0, 160.0, 90.0)
    kw = dict(max_features=512, num_levels=3, scale_factor=1.5)
    fc = frontend.extract_features(torch.as_tensor(img), cal, 10.0, **kw)
    fast_cuda.reset_launch_counts()
    fg = frontend.extract_features(torch.as_tensor(img).cuda(),
                                   cal.to("cuda"), 10.0, **kw)
    torch.cuda.synchronize()
    shapes = fast_cuda.launch_counts_by_shape()
    assert shapes == {("fast_detect_and_smooth", 180, 320): 1,
                      ("fast_detect_and_smooth", 120, 213): 1,
                      ("fast_detect_and_smooth", 80, 142): 1}
    assert int(fc.valid.sum()) > 100
    for name in ("valid", "octave"):
        assert torch.equal(getattr(fg, name).cpu(), getattr(fc, name))
    assert float((fg.uv.cpu() - fc.uv).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_cuda_distributed_ba_matches_single_device():
    """The parallel layer on the card: an 8-shard distributed BA with all
    shards on ``cuda:0`` against the single-device BA on the card, on the
    certification map (poses 1e-4, points 1e-3, MSE relative 1e-3, the
    tolerances of ``tests/test_distributed_ba.py``)."""
    _need_card()
    from mageslam_tpu_torch.mapping import global_ba
    from mageslam_tpu_torch.parallel import distributed_ba as dba
    from mageslam_tpu_torch.parallel.multiprocess import certification_map
    from mageslam_tpu_torch.solvers.bundle_adjust import bundle_adjust
    mesh = dba.make_mesh(devices=["cuda:0"] * 8)
    m, _ = certification_map(device="cuda:0")
    problem = global_ba.build_global_problem(m).problem
    res1 = bundle_adjust(problem, 0.01, 0.02, num_steps=6)
    resN = dba.distributed_bundle_adjust(dba.shard_problem(problem, mesh),
                                         0.01, 0.02, mesh, num_steps=6)
    assert resN.points.device.type == "cuda"
    assert float(resN.mean_sq_error) == pytest.approx(
        float(res1.mean_sq_error), rel=1e-3, abs=1e-9)
    assert float((resN.kf_poses - res1.kf_poses).abs().max()) <= 1e-4
    assert float((resN.points - res1.points).abs().max()) <= 1e-3


# ---------------------------------------------------------------------------
# the library's key and build (CPU)

_STUB = """
int fast_set_taps(void *t, void *s) { return 0; }
int fast_detect_and_smooth(void *a, void *b, void *c, int h, int w, float t,
                           void *s) { return 0; }
int fast_detect(void *a, void *b, int h, int w, float t, void *s)
{ return 0; }
int fast_launch_floor(int h, int w, void *s) { return 0; }
"""


@pytest.fixture
def fake_build(monkeypatch, tmp_path):
    """A build directory of its own, a stand-in ``nvcc`` under
    ``CUDA_HOME`` that links a stub of the kernel's C interface (and logs
    each build), and a version probe the test sets."""
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("needs a C compiler to link the stub library")
    (tmp_path / "stub.c").write_text(_STUB)
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    log = tmp_path / "builds.log"
    nvcc.write_text(
        "#!/bin/sh\n"
        "out=\n"
        "while [ $# -gt 0 ]; do\n"
        '  if [ "$1" = "-o" ]; then out="$2"; shift; fi; shift\n'
        "done\n"
        f'echo "$out" >> {log}\n'
        f'exec {cc} -shared -fPIC -o "$out" {tmp_path / "stub.c"}\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(fast_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(fast_cuda, "_host", None)
    version = {"text": "nvcc 12.9", "probes": 0}

    def probe():
        version["probes"] += 1
        return version["text"]
    monkeypatch.setattr(fast_cuda, "_nvcc_version", probe)
    return version, log


def _rekey(monkeypatch, version, text=None, node=None):
    if text is not None:
        version["text"] = text
    if node is not None:
        u = fast_cuda.platform.uname()
        monkeypatch.setattr(fast_cuda.platform, "uname",
                            lambda: u._replace(node=node))
    monkeypatch.setattr(fast_cuda, "_host", None)


def test_library_key_follows_compiler_and_host(monkeypatch, fake_build):
    version, _ = fake_build
    own = fast_cuda.library_path()
    assert fast_cuda.library_path() == own      # stable within a process
    assert version["probes"] == 1               # probed once
    _rekey(monkeypatch, version, text="nvcc 12.8")
    other_compiler = fast_cuda.library_path()
    _rekey(monkeypatch, version, text="nvcc 12.9", node="another-host")
    other_host = fast_cuda.library_path()
    assert len({own, other_compiler, other_host}) == 3
    _rekey(monkeypatch, version, node=fast_cuda.platform.uname().node
           + "-x")
    assert fast_cuda.library_path() not in (own, other_compiler, other_host)


def test_library_under_another_key_is_never_loaded(monkeypatch, fake_build):
    version, log = fake_build
    foreign_lib = fast_cuda.load()              # built under nvcc 12.9
    foreign = Path(foreign_lib._name)
    _rekey(monkeypatch, version, text="nvcc 12.8")
    lib = fast_cuda.load()
    assert Path(lib._name) == fast_cuda.library_path() != foreign
    assert log.read_text().count("\n") == 2    # built anew, not reused
    # with no compiler at all, the foreign library is still not loaded
    os.remove(lib._name)
    monkeypatch.setenv("CUDA_HOME", str(Path(log).parent / "nowhere"))
    monkeypatch.setenv("PATH", str(Path(log).parent / "nowhere"))
    monkeypatch.setattr(fast_cuda.Path, "exists",
                        lambda p: False if p.name == "nvcc"
                        else os.path.exists(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fast_cuda.load()
    assert foreign.exists()


def test_unloadable_library_under_this_key_is_built_anew(fake_build):
    _, log = fake_build
    path = fast_cuda.library_path()
    path.parent.mkdir(parents=True)
    path.write_bytes(b"truncated")              # ctypes cannot load it
    lib = fast_cuda.load()
    assert Path(lib._name) == path
    assert path.read_bytes()[:4] == b"\x7fELF"
    assert log.read_text().strip() != ""        # the build ran
