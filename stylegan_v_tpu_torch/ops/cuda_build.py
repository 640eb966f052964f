"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

Each source is compiled at first use with nvcc for sm_90a into a shared
library with a plain C interface, under `_build/` beside this package's
`csrc/`, and loaded with ctypes. A library's name carries a hash of its
source and flags, so an edited source is rebuilt; every source that is not
built yet builds at once, one nvcc each, all started together. The build
holds a file lock in `_build/`, so ranks started together on one host build
each library once, and the others wait for it and load it.

Nothing here runs when a module is imported: the CPU tests import every
module on a machine without nvcc.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List, Sequence

import torch

_PKG_DIR = Path(__file__).resolve().parents[1]
SOURCES = {name: _PKG_DIR / "csrc" / f"{name}.cu"
           for name in ("downfirdn2d_x2", "downfirdn2d_x2_bwd", "affine_warp",
                        "affine_warp_bwd", "upfirdn2d", "shear_pass",
                        "shear_resample_bwd", "shear_shift")}
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME   # imported only to build
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _library_path(name: str) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(SOURCES[name].parent.glob("*.cuh")))
    digest = hashlib.sha256(SOURCES[name].read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_libraries() -> List[Path]:
    """Compile every csrc source whose library is not built yet, all at once,
    under the build directory's lock."""
    import fcntl
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _build_unlocked()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build_unlocked() -> List[Path]:
    started = []
    for name in SOURCES:
        lib = _library_path(name)
        if lib.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        started.append((lib, tmp, cmd, proc))
    failures = []
    for lib, tmp, cmd, proc in started:
        out, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, lib)           # atomic: concurrent builds agree
        else:
            failures.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
        if os.path.exists(tmp):
            os.unlink(tmp)
    if failures:
        raise RuntimeError("\n".join(failures))
    return [_library_path(name) for name in SOURCES]


@functools.lru_cache(maxsize=None)
def entry_point(name: str, argtypes: Sequence, symbol: str = ""):
    """The C function `symbol` (by default `name`) of csrc/<name>.cu (built if
    need be); it returns a cudaError_t as an int. argtypes is a tuple of
    ctypes types."""
    build_libraries()
    fn = getattr(ctypes.CDLL(str(_library_path(name))), symbol or name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def on_cuda(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises on any other device."""
    if x.device.type == "cpu":
        return False
    if not x.is_cuda:
        raise ValueError(f"{name} runs on CPU or CUDA, got {x.device}")
    return True


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def launch(name: str, fn, args: Sequence, device: int) -> None:
    """Call the C entry point fn(*args, stream) on the current stream of CUDA
    device `device`, read as a raw handle (no Stream object; a device context
    only when `device` is not the current one); raise if it fails."""
    if device == torch._C._cuda_getDevice():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(device))
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(device))
    check_launch(name, err)
