"""ctypes wrapper for the native prefetching dataset loader
(native/dataloader.cpp): threaded PNG decode into float32 frames,
delivered in order while the device computes the previous frame.

Builds the shared library on demand (g++, zlib) and caches it next to
the source; falls back with ImportError if no toolchain is available so
callers can use the pure-Python path.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, Tuple

import numpy as np

from ..config import VinsConfig
from . import euroc as euroc_mod

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libvinsloader.so")
_lib = None


def _build_and_load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    src = os.path.join(_NATIVE_DIR, "dataloader.cpp")
    if (not os.path.exists(_LIB_PATH)
            or os.path.getmtime(_LIB_PATH) < os.path.getmtime(src)):
        subprocess.run(["make", "-C", _NATIVE_DIR, "libvinsloader.so"],
                       check=True, capture_output=True)
    lib = ctypes.CDLL(_LIB_PATH)
    lib.vl_open.restype = ctypes.c_void_p
    lib.vl_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_long,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int]
    lib.vl_next.restype = ctypes.c_long
    lib.vl_next.argtypes = [ctypes.c_void_p,
                            np.ctypeslib.ndpointer(np.float32)]
    lib.vl_close.argtypes = [ctypes.c_void_p]
    lib.vl_decode_png.restype = ctypes.c_int
    lib.vl_decode_png.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                  np.ctypeslib.ndpointer(np.float32)]
    _lib = lib
    return lib


def decode_png_native(path: str, width: int, height: int) -> np.ndarray:
    lib = _build_and_load()
    out = np.empty((height, width), np.float32)
    rc = lib.vl_decode_png(path.encode(), width, height, out)
    if rc != 0:
        raise IOError(f"native PNG decode failed: {path}")
    return out


class PrefetchingImageLoader:
    """Ordered, threaded image prefetcher over a path list."""

    def __init__(self, paths, width: int, height: int, n_workers: int = 2,
                 queue_cap: int = 4):
        self.lib = _build_and_load()
        self.paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self.paths))(*self.paths)
        self._arr = arr  # keep alive
        self.width, self.height = width, height
        self.handle = self.lib.vl_open(arr, len(self.paths), width, height,
                                       n_workers, queue_cap)
        self.n = len(paths)
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._i >= self.n:
            raise StopIteration
        out = np.empty((self.height, self.width), np.float32)
        idx = self.lib.vl_next(self.handle, out)
        if idx < 0:
            raise StopIteration
        self._i += 1
        return out

    def close(self):
        if self.handle:
            self.lib.vl_close(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeEurocLoader:
    """Aligned (frame, image) stream backed by the native prefetcher."""

    def __init__(self, data: euroc_mod.EurocData, cfg: VinsConfig,
                 start: int = 0, count=None, n_workers: int = 2):
        self.frames = list(euroc_mod.align_measurements(
            data, cfg, start=start, count=count))
        self.images = PrefetchingImageLoader(
            [f.image_path for f in self.frames],
            cfg.camera.width, cfg.camera.height, n_workers=n_workers)

    def __iter__(self) -> Iterator[Tuple[euroc_mod.AlignedFrame, np.ndarray]]:
        return zip(self.frames, self.images)
