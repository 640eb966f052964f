"""Hand-written Hopper kernels for the FIR resampling paths.

The PyTorch counterpart of stylegan_v_tpu/ops/pallas_kernels.py.

`downfirdn2d_x2(x, f)`: fused 2x FIR downsample of an NCHW tensor with a 4x4
filter and padding 1 on each side, equal to `downsample2d(x, f)` for a
4-tap `setup_filter`. It is the upfirdn2d case of every resnet skip of the
Discriminator. On a CUDA tensor it launches the CUDA kernel in
csrc/downfirdn2d_x2.cu (see the note there); on a CPU tensor it runs
`downfirdn2d_x2_plain`, its plain PyTorch version.

The kernel is built at first use with nvcc for sm_90a into a shared library
with a plain C interface, under `_build/` beside this package's `csrc/`, and
loaded with ctypes. The library's name carries a hash of the source, so an
edited source is rebuilt.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

_PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = _PKG_DIR / "csrc" / "downfirdn2d_x2.cu"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME   # imported only to build
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_library() -> Path:
    """Compile csrc/downfirdn2d_x2.cu unless its library is already built."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"libdownfirdn2d_x2-{digest[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                               + proc.stdout + proc.stderr)
        os.replace(tmp, lib)           # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    lib.downfirdn2d_x2.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                                   ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
    lib.downfirdn2d_x2.restype = ctypes.c_int
    return lib


def _flipped_filter(f) -> torch.Tensor:
    """The 4x4 filter as float32, flipped in both axes (true convolution)."""
    f = torch.as_tensor(f, dtype=torch.float32)
    if tuple(f.shape) != (4, 4):
        raise ValueError(f"downfirdn2d_x2 needs a 4x4 filter, got {tuple(f.shape)}")
    return f.flip([0, 1])


def _check_input(x: torch.Tensor) -> None:
    if x.ndim != 4:
        raise ValueError(f"downfirdn2d_x2 needs NCHW, got shape {tuple(x.shape)}")
    if x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"downfirdn2d_x2 needs even H and W, got {tuple(x.shape)}")


def downfirdn2d_x2_plain(x: torch.Tensor, f) -> torch.Tensor:
    """Plain PyTorch version: pad 1, depthwise stride-2 conv with the flipped
    filter, in float32, cast back to x's dtype."""
    _check_input(x)
    fk = _flipped_filter(f).to(x.device, non_blocking=True)
    C = x.shape[1]
    y = F.conv2d(F.pad(x.float(), [1, 1, 1, 1]), fk[None, None].expand(C, 1, 4, 4),
                 stride=2, groups=C)
    return y.to(x.dtype)


def downfirdn2d_x2(x: torch.Tensor, f) -> torch.Tensor:
    """Fused FIR 2x downsample, NCHW, 4x4 filter, padding 1 on each side.

    A CPU tensor goes to `downfirdn2d_x2_plain`. A CUDA tensor (float32 or
    bfloat16, contiguous) goes to the CUDA kernel, or raises; each launch adds
    one to `downfirdn2d_x2.launches`. f is a host tensor or array; a CUDA
    filter is copied to the host first.
    """
    _check_input(x)
    if x.device.type == "cpu":
        return downfirdn2d_x2_plain(x, f)
    if not x.is_cuda:
        raise ValueError(f"downfirdn2d_x2 runs on CPU or CUDA, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"downfirdn2d_x2 takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("downfirdn2d_x2 needs a contiguous NCHW tensor")
    fk = _flipped_filter(torch.as_tensor(f).detach().cpu())
    N, C, H, W = x.shape
    y = torch.empty((N, C, H // 2, W // 2), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    taps = (ctypes.c_float * 16)(*fk.reshape(-1).tolist())
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.downfirdn2d_x2(x.data_ptr(), y.data_ptr(), taps, _DTYPE_CODES[x.dtype],
                                 N * C, H, W, stream)
    if err != 0:
        raise RuntimeError(f"downfirdn2d_x2 launch failed with CUDA error {err}")
    downfirdn2d_x2.launches += 1
    return y


downfirdn2d_x2.launches = 0
