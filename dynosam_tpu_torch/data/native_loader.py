"""ctypes binding for the native C++ decode/prefetch runtime (the port's own
copy of `dynosam_tpu/data/native_loader.py`).

Wraps the repository's `native/libdynoloader.so` (PNG decoder + thread
pool, `native/dataloader.cpp`; `make -C native` rebuilds it), which it
loads and never modifies.  Falls back transparently to cv2 if the shared
library is missing; `available()` reports which path is active.  The
prefetching decoder keeps N decode jobs in flight on worker threads so
host-side image decode overlaps device compute — the role the reference's
data-interface thread plays (`dataprovider/DataInterfacePipeline.hpp`).
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional

import numpy as np

_LIB = None


def _find_lib() -> Optional[str]:
    here = os.path.dirname(os.path.abspath(__file__))
    cands = [
        os.path.join(here, "..", "..", "native", "libdynoloader.so"),
        os.path.join(here, "libdynoloader.so"),
    ]
    for c in cands:
        if os.path.exists(c):
            return os.path.abspath(c)
    return None


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    path = _find_lib()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.dyno_png_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.dyno_png_info.restype = ctypes.c_int
    lib.dyno_png_decode.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_long,
    ]
    lib.dyno_png_decode.restype = ctypes.c_int
    lib.dyno_pool_create.argtypes = [ctypes.c_int]
    lib.dyno_pool_create.restype = ctypes.c_void_p
    lib.dyno_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.dyno_pool_decode.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_long,
        ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def png_info(path: str):
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader not built")
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    b = ctypes.c_int()
    rc = lib.dyno_png_info(path.encode(), w, h, c, b)
    if rc != 0:
        raise IOError(f"png_info failed for {path}")
    return w.value, h.value, c.value, b.value


def decode_png(path: str) -> np.ndarray:
    """Decode a PNG into (H, W) or (H, W, C) uint8/uint16 array."""
    lib = _load()
    if lib is None:
        import cv2

        img = cv2.imread(path, -1)
        if img is None:
            raise IOError(path)
        return img
    w, h, c, b = png_info(path)
    dtype = np.uint16 if b == 16 else np.uint8
    out = np.empty(h * w * c, dtype)
    buf = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    rc = lib.dyno_png_decode(path.encode(), buf, out.nbytes)
    if rc < 0:
        raise IOError(f"png decode failed for {path} ({rc})")
    img = out.reshape(h, w, c) if c > 1 else out.reshape(h, w)
    return img


class PrefetchDecoder:
    """Thread-pool PNG decoder: submit paths, collect decoded arrays."""

    def __init__(self, n_threads: int = 4):
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader not built (make -C native)")
        self.lib = lib
        self.pool = lib.dyno_pool_create(n_threads)
        self.jobs = {}

    def submit(self, path: str):
        w, h, c, b = png_info(path)
        dtype = np.uint16 if b == 16 else np.uint8
        out = np.empty(h * w * c, dtype)
        done = np.zeros(1, np.int32)
        status = np.zeros(1, np.int32)
        self.jobs[path] = (out, done, status, (h, w, c))
        self.lib.dyno_pool_decode(
            self.pool,
            path.encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out.nbytes,
            done.ctypes.data,
            status.ctypes.data,
        )

    def get(self, path: str, timeout: float = 30.0) -> np.ndarray:
        import time

        out, done, status, (h, w, c) = self.jobs.pop(path)
        t0 = time.time()
        while not done[0]:
            if time.time() - t0 > timeout:
                raise TimeoutError(path)
            time.sleep(0.0005)
        if status[0] < 0:
            raise IOError(f"decode failed: {path} ({status[0]})")
        return out.reshape(h, w, c) if c > 1 else out.reshape(h, w)

    def close(self):
        if self.pool:
            self.lib.dyno_pool_destroy(self.pool)
            self.pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
