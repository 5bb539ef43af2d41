"""Wrappers of the hand-written CUDA FAST kernel (``csrc/fast_detect.cu``).

Replaces ``mageslam_tpu/ops/fast_pallas.py`` — ``detect_and_smooth`` (the
frontend's per-frame stage: NMS'd FAST-9/16 score + 7-tap Gaussian blur
from one read of the frame) and ``detect`` (score + NMS only).  The kernel
is a stencil on the ridge of the H100's roofline: 12 bytes and 75 to 250
float32 min/max/compare operations per pixel.  Its design — an exact
antipodal-pair early-out before the arc scan, candidates compacted per warp
so the scan runs with full lanes, the scan on integer keys with three-input
min/max, 32x16 tiles staged by 16-byte ``cp.async``, four pixels a thread
in the blur and the NMS — is set out in the source note of the ``.cu``
file; ``ops/fast.py`` holds the plain versions, ``antipodal_candidates``
among them.

Dispatch follows the tensor: a CUDA tensor launches the kernel (or
raises); a CPU tensor takes the plain version in ``ops/fast.py``.  There is
no fallback.  The shared library is built with ``nvcc`` from the package's
own source at first use into ``mageslam_tpu_torch/_build/`` and bound with
``ctypes``.  The library's name hashes the source, the flags, ``nvcc``'s
version and the host, so a library that a copied checkout carries from
another machine or compiler is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

from mageslam_tpu_torch.ops import fast, pyramid

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fast_detect.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
MAX_KSIZE = 2 * fast.PAD + 1

# kernel launches per entry point since the last reset (a run shows that
# its frames went through the kernel by reading these), and per entry
# point and image shape
_launches = {"fast_detect_and_smooth": 0, "fast_detect": 0}
_launches_by_shape: dict = {}
_lock = threading.Lock()
_lib = None
_taps_loaded: dict = {}
_host = None
build_seconds = None   # wall time of the build in this process, if any


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0
    _launches_by_shape.clear()


def launch_counts() -> dict:
    return dict(_launches)


def launch_counts_by_shape() -> dict:
    """{(entry point, h, w): launches} since the last reset."""
    return dict(_launches_by_shape)


def _count(name: str, img: torch.Tensor) -> None:
    _launches[name] += 1
    key = (name, *img.shape)
    _launches_by_shape[key] = _launches_by_shape.get(key, 0) + 1


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA FAST kernel cannot be "
                           "built (set CUDA_HOME or put nvcc on PATH)")
    return found


def _nvcc_version() -> str:
    """``nvcc --version`` (empty without a compiler)."""
    try:
        return subprocess.run([nvcc_path(), "--version"],
                              capture_output=True, text=True).stdout
    except (RuntimeError, OSError):
        return ""


def host_key() -> str:
    """What a built library depends on besides its source and flags: the
    compiler's version and the machine it was built on (computed once per
    process)."""
    global _host
    if _host is None:
        u = platform.uname()
        _host = "\n".join((_nvcc_version(), u.system, u.node, u.release,
                           u.machine))
    return _host


def library_path(source: Path = SOURCE) -> Path:
    key = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()
                         + host_key().encode()).hexdigest()[:16]
    return BUILD_DIR / f"libfast_detect_{key}.so"


def build(source: Path = SOURCE, verbose: bool = False) -> Path:
    """Compile the kernel library if it is not built under its key."""
    global build_seconds
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = Path(tmp) / out.name
        cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp_out),
               str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        if verbose:
            print(proc.stderr.strip())
        os.replace(tmp_out, out)
    build_seconds = time.perf_counter() - t0
    return out


def bind(path: Path) -> ctypes.CDLL:
    """Load a built kernel library and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fast_set_taps.argtypes = [vp, vp]
    lib.fast_set_taps.restype = ci
    lib.fast_detect_and_smooth.argtypes = [vp, vp, vp, ci, ci, cf, vp]
    lib.fast_detect_and_smooth.restype = ci
    lib.fast_detect.argtypes = [vp, vp, ci, ci, cf, vp]
    lib.fast_detect.restype = ci
    # the measuring aid; a source of an earlier commit may lack it
    if hasattr(lib, "fast_launch_floor"):
        lib.fast_launch_floor.argtypes = [ci, ci, vp]
        lib.fast_launch_floor.restype = ci
    return lib


def load(source: Path = SOURCE) -> ctypes.CDLL:
    """Build (if needed) and bind the library of ``source``.  A file under
    this key that ``ctypes`` cannot load (a truncated build) is built anew;
    a build that fails raises."""
    try:
        return bind(build(source))
    except OSError:
        library_path(source).unlink(missing_ok=True)
        return bind(build(source))


def use_library(lib: ctypes.CDLL) -> None:
    """Launch from ``lib`` (from ``bind``) instead of the package's own
    build: how ``tools/bench_fast_kernel.py`` puts the source of another
    commit behind the same wrappers, to time the two side by side."""
    global _lib
    with _lock:
        _lib = lib
        _taps_loaded.clear()   # constant memory belongs to a library


def _load():
    global _lib
    with _lock:
        if _lib is None:
            _lib = load()
    return _lib


def _check(img: torch.Tensor) -> torch.Tensor:
    if img.ndim != 2:
        raise ValueError(f"expected an (H, W) image, got {tuple(img.shape)}")
    if img.dtype != torch.float32:
        img = img.to(torch.float32)
    return img.contiguous()


def _stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _set_taps(lib, ksize: int, device) -> None:
    key = (str(device), ksize)
    if _taps_loaded.get(str(device)) == key:
        return
    if ksize % 2 == 0 or ksize > MAX_KSIZE:
        raise ValueError(f"ksize {ksize} must be odd and <= {MAX_KSIZE}")
    taps = ([1.0] if ksize <= 1 else pyramid.gaussian_kernel1d(ksize)
            .tolist())
    pad = (MAX_KSIZE - len(taps)) // 2
    host = (ctypes.c_float * MAX_KSIZE)(*([0.0] * pad + taps + [0.0] * pad))
    err = lib.fast_set_taps(ctypes.cast(host, ctypes.c_void_p),
                            _stream_ptr(device))
    if err != 0:
        raise RuntimeError(f"fast_set_taps failed: CUDA error {err}")
    _taps_loaded[str(device)] = key


def detect_and_smooth(img: torch.Tensor, threshold: float, ksize: int = 7):
    """(NMS'd FAST score, Gaussian-smoothed image), both (H, W) float32."""
    if img.device.type == "cpu":
        return fast.detect_and_smooth(img, threshold, ksize)
    if img.device.type != "cuda":
        raise RuntimeError(f"no FAST kernel for device {img.device}")
    img = _check(img)
    lib = _load()
    _set_taps(lib, ksize, img.device)
    h, w = img.shape
    score = torch.empty_like(img)
    smooth = torch.empty_like(img)
    err = lib.fast_detect_and_smooth(img.data_ptr(), score.data_ptr(),
                                     smooth.data_ptr(), h, w,
                                     float(threshold),
                                     _stream_ptr(img.device))
    if err != 0:
        raise RuntimeError(f"fast_detect_and_smooth launch failed: "
                           f"CUDA error {err}")
    _count("fast_detect_and_smooth", img)
    return score, smooth


def detect(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """NMS'd FAST-9/16 score map, (H, W) float32."""
    if img.device.type == "cpu":
        return fast.detect(img, threshold)
    if img.device.type != "cuda":
        raise RuntimeError(f"no FAST kernel for device {img.device}")
    img = _check(img)
    lib = _load()
    h, w = img.shape
    score = torch.empty_like(img)
    err = lib.fast_detect(img.data_ptr(), score.data_ptr(), h, w,
                          float(threshold), _stream_ptr(img.device))
    if err != 0:
        raise RuntimeError(f"fast_detect launch failed: CUDA error {err}")
    _count("fast_detect", img)
    return score


def launch_floor(img: torch.Tensor) -> None:
    """Launch an empty kernel on the grid the FAST kernel uses for ``img``:
    the measuring reference for what any launch of that shape costs.  It is
    not a kernel of the port and is not counted."""
    if img.device.type != "cuda" or img.ndim != 2:
        raise ValueError("expected an (H, W) CUDA image")
    h, w = img.shape
    err = _load().fast_launch_floor(h, w, _stream_ptr(img.device))
    if err != 0:
        raise RuntimeError(f"fast_launch_floor failed: CUDA error {err}")
