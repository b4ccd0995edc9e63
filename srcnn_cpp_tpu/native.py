"""ctypes bindings for the native host runtime (native/srcnn_host.cpp).

The accelerator owns the conv stack; this module exposes the C++ host-side layer —
bit-exact uint8 bicubic resize, the generic separable resampler, fixed-point
colorspace conversion, and a monotonic tick timer — mirroring the native
layer of the reference (resize: srcnn.cpp:577-582 + frawscale.cpp; color:
srcnn.cpp:509,657; timer: tick.cpp).

The library is built on demand from the committed ``native/`` sources into
``native/build/`` (``make -C native``); all entry points have
pure-Python/NumPy fallbacks via the oracle modules, so the framework works
without a compiler — the native path is a host-throughput optimization.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_SRC = _NATIVE_DIR / "srcnn_host.cpp"
_SO = _NATIVE_DIR / "build" / "libsrcnn_host.so"

FILTERS = {"box": 0, "bilinear": 1, "mitchell": 2, "catmull_rom": 3,
           "lanczos3": 4, "cubic_matlab": 5}

_lib = None


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                       capture_output=True, timeout=300)
        return _SO.exists()
    except Exception:
        return False


def _stale() -> bool:
    """True when the .so is missing or older than the C++ source."""
    try:
        return (not _SO.exists()
                or (_SRC.exists()
                    and _SO.stat().st_mtime < _SRC.stat().st_mtime))
    except OSError:
        return True


def load(build: bool = True):
    """Load (rebuilding when stale) the native library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    if _stale() and build:
        _build()
    if not _SO.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:  # wrong arch / corrupt artifact: fall back to Python
        return None
    lib.srcnn_host_tick_ms.restype = ctypes.c_double
    lib.srcnn_host_version.restype = ctypes.c_int
    lib.srcnn_host_resize_cubic_u8.restype = ctypes.c_int
    lib.srcnn_host_resize_separable_f32.restype = ctypes.c_int
    lib.srcnn_host_bgr2ycrcb_u8.restype = ctypes.c_int
    lib.srcnn_host_ycrcb2bgr_u8.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    return load() is not None


def tick_ms() -> float:
    return float(load().srcnn_host_tick_ms())


def _u8ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def resize_cubic_u8(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """OpenCV-4.6-bit-exact INTER_CUBIC resize of a uint8 plane (C++)."""
    lib = load()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    ih, iw = img.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    out = np.empty((oh, ow), np.uint8)
    rc = lib.srcnn_host_resize_cubic_u8(_u8ptr(img), ih, iw, _u8ptr(out), oh, ow)
    if rc != 0:
        raise RuntimeError(f"srcnn_host_resize_cubic_u8 failed: {rc}")
    return out


def resize_separable_f32(img: np.ndarray, out_hw: tuple[int, int],
                         method: str = "mitchell") -> np.ndarray:
    """Generic separable float resize (C++ weights-table engine)."""
    lib = load()
    img = np.ascontiguousarray(img, dtype=np.float32)
    ih, iw = img.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    out = np.empty((oh, ow), np.float32)
    fptr = ctypes.POINTER(ctypes.c_float)
    rc = lib.srcnn_host_resize_separable_f32(
        img.ctypes.data_as(fptr), ih, iw, out.ctypes.data_as(fptr), oh, ow,
        FILTERS[method])
    if rc != 0:
        raise RuntimeError(f"srcnn_host_resize_separable_f32 failed: {rc}")
    return out


def bgr2ycrcb_u8(bgr: np.ndarray) -> np.ndarray:
    lib = load()
    bgr = np.ascontiguousarray(bgr, dtype=np.uint8)
    out = np.empty_like(bgr)
    rc = lib.srcnn_host_bgr2ycrcb_u8(_u8ptr(bgr), _u8ptr(out),
                                     ctypes.c_int64(bgr.size // 3))
    if rc != 0:
        raise RuntimeError(f"srcnn_host_bgr2ycrcb_u8 failed: {rc}")
    return out


def ycrcb2bgr_u8(ycrcb: np.ndarray) -> np.ndarray:
    lib = load()
    ycrcb = np.ascontiguousarray(ycrcb, dtype=np.uint8)
    out = np.empty_like(ycrcb)
    rc = lib.srcnn_host_ycrcb2bgr_u8(_u8ptr(ycrcb), _u8ptr(out),
                                     ctypes.c_int64(ycrcb.size // 3))
    if rc != 0:
        raise RuntimeError(f"srcnn_host_ycrcb2bgr_u8 failed: {rc}")
    return out
