"""Frame input: the repo's C++ frame pump through ctypes, or a PNG reader
on the standard library.

Port of ``mageslam_tpu/io/native_loader.py``.  The native route compiles
``native/frame_pump.cpp`` (threaded PNG / PGM / JPEG decode, bilinear
resize, a bounded prefetch ring) with ``g++`` at first use into the
git-ignored ``mageslam_tpu_torch/_build/``, with ``native/Makefile``'s
flags and libraries.  The library's name hashes the source, the flags, the
compiler's version and the host, so a library built on another machine (a
copied checkout, a prebuilt ``native/libmageslam_io.so``) is never loaded,
and one under this host's name that no longer loads is built anew.

Where the library cannot be built (no compiler, no libpng or libjpeg
headers) the route is ``"python"``: 8-bit grey, grey + alpha, RGB and RGBA
PNGs without interlacing, decoded with ``zlib`` and numpy (RGB to grey with
libpng's default integer weights, as the native route converts), resized
with the frame pump's bilinear arithmetic in float32.  The route is never
chosen silently: ``backend()`` and ``FramePump.backend`` name it, and a
failed build keeps the compiler's message in ``build_error`` and logs it.
"""

from __future__ import annotations

import ctypes
import hashlib
import heapq
import logging
import os
import platform
import shutil
import struct
import subprocess
import tempfile
import time
import zlib
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "frame_pump.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LIBS = ("-lpng16", "-ljpeg", "-lz", "-lpthread")
# libpng's default RGB -> grey weights (sRGB primaries, 15-bit fixed point)
_RGB_WEIGHTS = (6968, 23434, 32768 - 6968 - 23434)
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

log = logging.getLogger(__name__)
_lib = None
_tried = False
_host: Optional[str] = None
build_error: Optional[str] = None   # the compiler's message of a failure
build_seconds: Optional[float] = None


def _compiler() -> Optional[str]:
    return os.environ.get("CXX") or shutil.which("g++")


def host_key() -> str:
    """What a built library depends on besides its source and flags: the
    compiler's version and the machine it was linked on."""
    global _host
    if _host is None:
        cxx, version = _compiler(), ""
        if cxx is not None:
            try:
                version = subprocess.run([cxx, "--version"],
                                         capture_output=True,
                                         text=True).stdout
            except OSError:
                pass
        u = platform.uname()
        _host = "\n".join((cxx or "", version, u.system, u.node, u.release,
                           u.machine))
    return _host


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        CXX_FLAGS + LIBS).encode() + host_key().encode()).hexdigest()[:16]
    return BUILD_DIR / f"libmageslam_io_{key}.so"


def build() -> Path:
    """Compile the frame pump if it is not built under this key."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = Path(tmp) / out.name
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp_out),
                               str(SOURCE), *LIBS],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp_out, out)
    build_seconds = time.perf_counter() - t0
    return out


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    cp, ci, vp = ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p
    fp = ctypes.POINTER(ctypes.c_float)
    lib.pump_create.restype = vp
    lib.pump_create.argtypes = [ctypes.POINTER(cp), ci, ci, ci, ci, ci]
    lib.pump_next.restype = ci
    lib.pump_next.argtypes = [vp, fp]
    lib.pump_destroy.argtypes = [vp]
    lib.pump_decode_errors.restype = ci
    lib.pump_decode_errors.argtypes = [vp]
    lib.read_image_gray.restype = ci
    lib.read_image_gray.argtypes = [cp, fp, ci, ci]
    lib.image_size.restype = ci
    lib.image_size.argtypes = [cp, ctypes.POINTER(ci), ctypes.POINTER(ci)]
    return lib


def load_library() -> Optional[ctypes.CDLL]:
    """The built frame pump, or None (once a build has failed, for the
    rest of the process; ``build_error`` says why)."""
    global _lib, _tried, build_error
    if _lib is None and not _tried:
        _tried = True
        try:
            try:
                _lib = _bind(build())
            except OSError:     # a library left under this key: build anew
                library_path().unlink(missing_ok=True)
                _lib = _bind(build())
        except (RuntimeError, OSError) as e:
            build_error = str(e)
            log.warning("native frame pump unavailable, decoding PNGs in "
                        "Python: %s", build_error)
    return _lib


def backend() -> str:
    """``"native"`` (the C++ frame pump) or ``"python"``."""
    return "native" if load_library() is not None else "python"


# ---------------------------------------------------------------------------
# the Python route

def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG scanline filters: (h, stride) uint8."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype == 1:
            cur = line.reshape(-1, bpp).cumsum(0).reshape(-1) & 0xFF
        elif ftype in (3, 4):
            cur = line.tolist()
            up = prev.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    cur[i] = (cur[i] + ((a + up[i]) >> 1)) & 0xFF
                    continue
                c = up[i - bpp] if i >= bpp else 0
                p = a + up[i] - c
                pa, pb, pc = abs(p - a), abs(p - up[i]), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (
                    up[i] if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.asarray(cur, np.int64)
        else:
            raise ValueError(f"PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def _png_gray(path: str) -> np.ndarray:
    """An 8-bit grey / grey+alpha / RGB / RGBA non-interlaced PNG as (H, W)
    uint8 grey."""
    data = Path(path).read_bytes()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG (the Python route reads PNG "
                         "only)")
    pos, idat, header = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, color, _, _, interlace = header
    channels = {0: 1, 4: 2, 2: 3, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: bit depth {depth}, colour type {color}, "
                         f"interlace {interlace}: the Python route reads "
                         "8-bit grey/RGB(A) PNGs without interlacing")
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * channels,
                   channels).reshape(h, w, channels)
    if channels <= 2:
        return px[..., 0]
    rgb = px[..., :3].astype(np.int64)
    grey = (_RGB_WEIGHTS[0] * rgb[..., 0] + _RGB_WEIGHTS[1] * rgb[..., 1]
            + _RGB_WEIGHTS[2] * rgb[..., 2]) >> 15
    same = (rgb[..., 0] == rgb[..., 1]) & (rgb[..., 0] == rgb[..., 2])
    return np.where(same, rgb[..., 0], grey).astype(np.uint8)


def _resize_bilinear(src: np.ndarray, width: int, height: int) -> np.ndarray:
    """``frame_pump.cpp``'s bilinear resize, in float32 operation by
    operation (pixel centres, clamped at the far edge)."""
    src = np.asarray(src, np.float32)
    h0, w0 = src.shape
    if (w0, h0) == (width, height):
        return src.copy()
    f32 = np.float32

    def taps(n_out, n_in):
        s = f32(n_in) / f32(n_out)
        f = (np.arange(n_out, dtype=f32) + f32(0.5)) * s - f32(0.5)
        i0 = np.maximum(f.astype(np.int64), 0)
        i1 = np.where(i0 + 1 < n_in, i0 + 1, n_in - 1)
        wgt = np.maximum(f - i0.astype(f32), f32(0))
        return i0, i1, wgt

    y0, y1, wy = taps(height, h0)
    x0, x1, wx = taps(width, w0)
    one = f32(1)
    a = src[y0][:, x0] * (one - wx) + src[y0][:, x1] * wx
    b = src[y1][:, x0] * (one - wx) + src[y1][:, x1] * wx
    return (a * (one - wy)[:, None] + b * wy[:, None]).astype(f32)


def _python_read(path: str, width: int, height: int) -> np.ndarray:
    return _resize_bilinear(_png_gray(path), width, height)


# ---------------------------------------------------------------------------

def read_image_gray(path: str, width: int, height: int) -> np.ndarray:
    """One image -> (height, width) float32 grey in [0, 255]."""
    lib = load_library()
    if lib is None:
        return _python_read(path, width, height)
    out = np.empty((height, width), np.float32)
    rc = lib.read_image_gray(str(path).encode(), out.ctypes.data_as(
        ctypes.POINTER(ctypes.c_float)), width, height)
    if rc != 0:
        raise IOError(f"native decode failed: {path}")
    return out


def image_size(path: str) -> tuple[int, int]:
    """(width, height) of an image file."""
    lib = load_library()
    if lib is None:
        head = Path(path).read_bytes()[:24]
        if head[:8] != _PNG_SIGNATURE:
            raise ValueError(f"{path}: not a PNG (the Python route reads "
                             "PNG only)")
        return struct.unpack(">II", head[16:24])
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.image_size(str(path).encode(), ctypes.byref(w),
                      ctypes.byref(h)) != 0:
        raise IOError(f"native decode failed: {path}")
    return w.value, h.value


class FramePump:
    """Ordered prefetching frame iterator over image paths: yields
    (index, (height, width) float32 grey); frames that fail to decode are
    skipped and counted.  ``backend`` names the route."""

    def __init__(self, paths: Sequence[str], width: int, height: int,
                 capacity: int = 8, n_threads: int = 2):
        self._paths = [str(p) for p in paths]
        self._w, self._h = width, height
        self._lib = load_library()
        self.backend = "native" if self._lib is not None else "python"
        self._pump = None
        self._errors = 0
        if self._lib is not None and self._paths:
            arr = (ctypes.c_char_p * len(self._paths))(
                *[p.encode() for p in self._paths])
            self._pump = self._lib.pump_create(
                arr, len(self._paths), width, height, capacity, n_threads)
            self._keepalive = arr

    def __iter__(self) -> Iterator[tuple[int, np.ndarray]]:
        if self._pump is None:
            for i, p in enumerate(self._paths):
                try:
                    frame = _python_read(p, self._w, self._h)
                except (OSError, ValueError, zlib.error):
                    self._errors += 1
                    continue
                yield i, frame
            return
        # native route: decoder threads finish out of order; a heap puts
        # the frames back in order
        heap: list = []
        next_idx, received = 0, 0
        buf = np.empty((self._h, self._w), np.float32)
        while received < len(self._paths):
            rc = self._lib.pump_next(
                self._pump, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if rc == -1000000:
                break
            received += 1
            idx = rc if rc >= 0 else -rc - 1
            heapq.heappush(heap, (idx, buf.copy() if rc >= 0 else None))
            while heap and heap[0][0] == next_idx:
                i, frame = heapq.heappop(heap)
                if frame is not None:
                    yield i, frame
                next_idx += 1
        while heap:
            i, frame = heapq.heappop(heap)
            if frame is not None:
                yield i, frame

    def decode_errors(self) -> int:
        if self._pump is None:
            return self._errors
        return self._lib.pump_decode_errors(self._pump)

    def close(self):
        if self._pump is not None:
            self._lib.pump_destroy(self._pump)
            self._pump = None

    def __del__(self):
        self.close()


def scan_dataset(root: str) -> list[str]:
    """Image paths for standard layouts: EuRoC (mav0/cam0/data/*.png),
    TUM (rgb/*.png), or a flat directory of images."""
    root_p = Path(root)
    candidates = [root_p / "mav0" / "cam0" / "data", root_p / "rgb", root_p]
    exts = {".png", ".pgm", ".ppm", ".jpg", ".jpeg"}
    for c in candidates:
        if c.is_dir():
            files = sorted(p for p in c.iterdir() if p.suffix.lower()
                           in exts)
            if files:
                return [str(p) for p in files]
    return []
