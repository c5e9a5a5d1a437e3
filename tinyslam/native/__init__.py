"""ctypes bindings to the native runtime (decode.cpp, loader.cpp).

The shared library is built on first use with the in-tree Makefile (g++ +
zlib only).  See module docstrings in the .cpp files for the role of this
layer relative to the reference's native code (SURVEY §2c).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SO = _DIR / "libtinyslam_native.so"
_lock = threading.Lock()
_lib = None


def _build() -> None:
    """Incremental ``make``: rebuilds the library only when a source is newer,
    so a stale .so never outlives the committed sources."""
    subprocess.run(
        ["make", "-s"], cwd=_DIR, check=True, capture_output=True, text=True
    )


def get_lib() -> ctypes.CDLL:
    """Load (building if needed) the native library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        _build()
        lib = ctypes.CDLL(str(_SO))
        lib.ts_decode_image.restype = ctypes.c_int
        lib.ts_decode_image.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.ts_loader_create.restype = ctypes.c_void_p
        lib.ts_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
        ]
        lib.ts_loader_next.restype = ctypes.c_int64
        lib.ts_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.ts_loader_peek.restype = None
        lib.ts_loader_peek.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.ts_loader_destroy.restype = None
        lib.ts_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def decode_image(path: str | os.PathLike) -> np.ndarray:
    """Decode PNG/PGM/PPM to (H, W) or (H, W, C) uint8/uint16."""
    lib = get_lib()
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    c = ctypes.c_int32()
    bd = ctypes.c_int32()
    p = str(path).encode()
    rc = lib.ts_decode_image(p, None, 0, w, h, c, bd)
    if rc != 0:
        raise IOError(f"cannot decode {path} (rc={rc})")
    dtype = np.uint16 if bd.value == 16 else np.uint8
    buf = np.empty(h.value * w.value * c.value, dtype)
    rc = lib.ts_decode_image(
        p, buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes, w, h, c, bd
    )
    if rc != 0:
        raise IOError(f"decode failed for {path} (rc={rc})")
    img = buf.reshape(h.value, w.value, c.value)
    return img[..., 0] if c.value == 1 else img


class FrameLoader:
    """Async prefetching iterator over image files (native thread pool)."""

    def __init__(self, paths: list[str | os.PathLike], capacity: int = 8,
                 threads: int = 4):
        self._lib = get_lib()
        self._paths = [str(p).encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._n = len(self._paths)
        self._h = self._lib.ts_loader_create(arr, self._n, capacity, threads)
        if not self._h:
            raise RuntimeError("loader creation failed")

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._h is None:
            raise StopIteration
        w = ctypes.c_int32()
        h = ctypes.c_int32()
        c = ctypes.c_int32()
        bd = ctypes.c_int32()
        self._lib.ts_loader_peek(self._h, 0, w, h, c, bd)
        if w.value == 0:
            self.close()
            raise StopIteration
        dtype = np.uint16 if bd.value == 16 else np.uint8
        buf = np.empty(h.value * w.value * c.value, dtype)
        rc = self._lib.ts_loader_next(
            self._h, buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes,
            w, h, c, bd,
        )
        if rc == -1:
            self.close()
            raise StopIteration
        if rc == -2:
            raise IOError("frame decode failed")
        if rc == -3:
            raise IOError("buffer too small")
        img = buf.reshape(h.value, w.value, c.value)
        return img[..., 0] if c.value == 1 else img

    def close(self):
        if self._h is not None:
            self._lib.ts_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
