"""ctypes wrapper + build-on-first-use for the native JPEG batch decoder.

A copy of stylegan_v_tpu/native/fastjpeg.py. It compiles fastjpeg.cpp with
g++ and -ljpeg into stylegan_v_tpu_torch/_build/ (md5-keyed on the source,
with a lock against two processes building it at once) at first use,
never at import.
This is a host-side decoder, not a device kernel: callers check
`is_available()` and use PIL otherwise (data/dataset.py), as the JAX
package does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import List, Optional

import numpy as np

_lib = None
_lib_lock = threading.Lock()
_build_failed = False

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fastjpeg.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")


def _build() -> Optional[ctypes.CDLL]:
    with open(_SRC, "rb") as f:
        digest = hashlib.md5(f.read()).hexdigest()[:16]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so_path = os.path.join(_BUILD_DIR, f"fastjpeg-{digest}.so")
    if not os.path.exists(so_path):
        lock = so_path + ".lock"
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
            tmp = so_path + ".tmp"
            cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                   "-std=c++17", _SRC, "-o", tmp, "-ljpeg", "-lpthread"]
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
        except FileExistsError:
            for _ in range(600):        # another process is building
                if os.path.exists(so_path):
                    break
                time.sleep(0.1)
        finally:
            try:
                os.remove(lock)
            except OSError:
                pass
    lib = ctypes.CDLL(so_path)
    lib.decode_jpeg_batch.restype = ctypes.c_int
    lib.decode_jpeg_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.probe_jpeg.restype = ctypes.c_int
    lib.probe_jpeg.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                               ctypes.POINTER(ctypes.c_int)]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lib_lock:
        if _lib is None and not _build_failed:
            try:
                _lib = _build()
            except (OSError, subprocess.SubprocessError):
                _build_failed = True
    return _lib


def is_available() -> bool:
    return _get_lib() is not None


def probe_jpeg(data: bytes):
    """Returns (H, W, C) or None."""
    lib = _get_lib()
    if lib is None:
        return None
    dims = (ctypes.c_int * 3)()
    if lib.probe_jpeg(data, len(data), dims) != 0:
        return None
    return int(dims[0]), int(dims[1]), int(dims[2])


def decode_jpeg_batch(buffers: List[bytes], height: int, width: int,
                      channels: int = 3, num_threads: int = 0) -> np.ndarray:
    """Decode a list of JPEG byte strings into [N, H, W, C] uint8 using the
    native thread pool (GIL-free). Raises on failure."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native fastjpeg unavailable")
    n = len(buffers)
    out = np.empty((n, height, width, channels), np.uint8)
    datas = (ctypes.c_char_p * n)(*buffers)
    sizes = (ctypes.c_size_t * n)(*[len(b) for b in buffers])
    rc = lib.decode_jpeg_batch(datas, sizes, n,
                               out.ctypes.data_as(ctypes.c_void_p),
                               height, width, channels, num_threads)
    if rc != 0:
        raise ValueError(f"JPEG decode failed for image index {rc - 1} "
                         f"(corrupt stream or unexpected dimensions)")
    return out
