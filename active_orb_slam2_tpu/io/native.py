"""ctypes bindings for the native frame IO library (native/frameio.cpp).

The reference's host runtime is C++ end-to-end; here the host-side hot
path (image decode + read-ahead) is likewise native: a zlib-based
PNG/PGM decoder and a pthread prefetcher that keeps decoded frames
ahead of the SLAM loop.  Falls back to PIL transparently when the
shared library cannot be built.  ``build_native()`` compiles it from
the tracked source with g++ into ``build/`` at first use (~2 s); the
binary is never committed.
"""

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_LIB = None
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO, "native")
_SO_PATH = os.path.join(_REPO, "build", "libframeio.so")


def build_native(force: bool = False) -> bool:
    """Compile native/frameio.cpp -> libframeio.so; returns success."""
    src = os.path.join(_NATIVE_DIR, "frameio.cpp")
    if not os.path.exists(src):
        return False
    if os.path.exists(_SO_PATH) and not force and \
            os.path.getmtime(_SO_PATH) >= os.path.getmtime(src):
        return True
    try:
        os.makedirs(os.path.dirname(_SO_PATH), exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", src,
             "-o", _SO_PATH, "-lz", "-lpthread"],
            check=True, capture_output=True)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is not None:
        return _LIB
    if not os.path.exists(_SO_PATH) and not build_native():
        return None
    lib = ctypes.CDLL(_SO_PATH)
    lib.fio_decode_gray.restype = ctypes.c_int
    lib.fio_decode_gray.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.fio_open.restype = ctypes.c_void_p
    lib.fio_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                             ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.fio_next.restype = ctypes.c_int
    lib.fio_next.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.fio_close.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


MAX_PIXELS = 4096 * 3072


def decode_gray(path: str):
    """Decode an image to (gray uint8 [H, W]) or (depth uint16 [H, W])
    for 16-bit PNGs.  Native path with PIL fallback."""
    lib = _lib()
    if lib is not None:
        out8 = np.empty(MAX_PIXELS, np.uint8)
        out16 = np.empty(MAX_PIXELS, np.uint16)
        w = ctypes.c_int()
        h = ctypes.c_int()
        bd = ctypes.c_int()
        ok = lib.fio_decode_gray(
            path.encode(), out8.ctypes.data_as(ctypes.c_void_p),
            out16.ctypes.data_as(ctypes.c_void_p), MAX_PIXELS,
            ctypes.byref(w), ctypes.byref(h), ctypes.byref(bd))
        if ok:
            n = w.value * h.value
            if bd.value == 16:
                return out16[:n].reshape(h.value, w.value).copy()
            return out8[:n].reshape(h.value, w.value).copy()
    from PIL import Image
    im = Image.open(path)
    if im.mode in ("I;16", "I"):
        return np.asarray(im, dtype=np.uint16)
    return np.asarray(im.convert("L"), dtype=np.uint8)


class PrefetchingReader:
    """Read-ahead frame reader over a list of image paths."""

    def __init__(self, paths, prefetch: int = 8, threads: int = 2):
        self.paths = list(paths)
        self._i = 0
        lib = _lib()
        self._lib = lib
        if lib is not None:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            self._keepalive = arr
            self._h = lib.fio_open(arr, len(self.paths), prefetch,
                                   threads, 0)
        else:
            self._h = None

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= len(self.paths):
            raise StopIteration
        path = self.paths[self._i]
        self._i += 1
        if self._h:
            out8 = np.empty(MAX_PIXELS, np.uint8)
            out16 = np.empty(MAX_PIXELS, np.uint16)
            w = ctypes.c_int()
            h = ctypes.c_int()
            bd = ctypes.c_int()
            ok = self._lib.fio_next(
                self._h, out8.ctypes.data_as(ctypes.c_void_p),
                out16.ctypes.data_as(ctypes.c_void_p), MAX_PIXELS,
                ctypes.byref(w), ctypes.byref(h), ctypes.byref(bd))
            if ok:
                n = w.value * h.value
                src = out16 if bd.value == 16 else out8
                return src[:n].reshape(h.value, w.value).copy()
            # decode failure: fall back for this frame
        return decode_gray(path)

    def close(self):
        if self._h:
            self._lib.fio_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
