"""Hand-written Hopper kernels for the FIR resampling paths.

The PyTorch counterpart of stylegan_v_tpu/ops/pallas_kernels.py.

`downfirdn2d_x2(x, f)` (K1): fused 2x FIR downsample of an NCHW tensor with a
4x4 filter and padding 1 on each side, equal to `downsample2d(x, f)` for a
4-tap `setup_filter`. It is the upfirdn2d case of every resnet skip of the
Discriminator.

`downfirdn2d_x2_bwd(dy, f)` (K1-bwd): its adjoint, a 2x FIR upsample of
[N, C, H/2, W/2] to [N, C, H, W] with the same filter and gain 1. The JAX
package has no kernel for it: jax.grad derives it.

On a CUDA tensor each launches its CUDA kernel in csrc/ (see the note there)
or raises; on a CPU tensor it runs its plain PyTorch version (`*_plain`).

`_DownFirX2` and `_UpFirX2` are the pair of autograd Functions that make K1
differentiable to any order: K1's backward is K1-bwd and K1-bwd's backward
is K1. The filter is a host constant and takes no gradient.

Each kernel is built at first use with nvcc for sm_90a into a shared library
with a plain C interface, under `_build/` beside this package's `csrc/`, and
loaded with ctypes. A library's name carries a hash of its source and flags,
so an edited source is rebuilt; the sources build in parallel, one nvcc each.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List

import torch
import torch.nn.functional as F

_PKG_DIR = Path(__file__).resolve().parents[1]
SOURCES = {name: _PKG_DIR / "csrc" / f"{name}.cu"
           for name in ("downfirdn2d_x2", "downfirdn2d_x2_bwd")}
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME   # imported only to build
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_libraries() -> List[Path]:
    """Compile every csrc source whose library is not built yet, all at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
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
def _entry_point(name: str):
    build_libraries()
    fn = getattr(ctypes.CDLL(str(_library_path(name))), name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                   ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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


def _launch(wrapper, inp: torch.Tensor, out: torch.Tensor, f, H: int, W: int) -> None:
    """Launch the kernel of `wrapper` (its C entry point has the wrapper's name)
    from inp into out, over N*C planes of the full-size H x W; count it."""
    name = wrapper.__name__
    if inp.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} takes float32 or bfloat16, got {inp.dtype}")
    if not inp.is_contiguous():
        raise ValueError(f"{name} needs a contiguous NCHW tensor")
    if out.numel() == 0:
        return
    fk = _flipped_filter(torch.as_tensor(f).detach().cpu())
    taps = (ctypes.c_float * 16)(*fk.reshape(-1).tolist())
    fn = _entry_point(name)
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream(inp.device).cuda_stream
        err = fn(inp.data_ptr(), out.data_ptr(), taps, _DTYPE_CODES[inp.dtype],
                 inp.shape[0] * inp.shape[1], H, W, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    wrapper.launches += 1


def _on_cuda(x: torch.Tensor, name: str) -> bool:
    if x.device.type == "cpu":
        return False
    if not x.is_cuda:
        raise ValueError(f"{name} runs on CPU or CUDA, got {x.device}")
    return True


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
    filter is copied to the host first. No autograd graph: `_DownFirX2`
    carries the gradient.
    """
    _check_input(x)
    if not _on_cuda(x, "downfirdn2d_x2"):
        return downfirdn2d_x2_plain(x, f)
    N, C, H, W = x.shape
    y = torch.empty((N, C, H // 2, W // 2), dtype=x.dtype, device=x.device)
    _launch(downfirdn2d_x2, x, y, f, H, W)
    return y


downfirdn2d_x2.launches = 0


def downfirdn2d_x2_bwd_plain(dy: torch.Tensor, f) -> torch.Tensor:
    """Plain PyTorch version of K1's adjoint: a depthwise stride-2 transposed
    conv with the flipped filter, in float32, cast back to dy's dtype. The
    upfirdn2d form is upfirdn2d(dy, f, up=2, padding=[2,1,2,1], flip_filter=True)."""
    if dy.ndim != 4:
        raise ValueError(f"downfirdn2d_x2_bwd needs NCHW, got shape {tuple(dy.shape)}")
    fk = _flipped_filter(f).to(dy.device, non_blocking=True)
    C = dy.shape[1]
    dx = F.conv_transpose2d(dy.float(), fk[None, None].expand(C, 1, 4, 4), stride=2,
                            padding=1, groups=C)
    return dx.to(dy.dtype)


def downfirdn2d_x2_bwd(dy: torch.Tensor, f) -> torch.Tensor:
    """The adjoint of `downfirdn2d_x2(., f)`: [N, C, Ho, Wo] -> [N, C, 2Ho, 2Wo].

    A CPU tensor goes to `downfirdn2d_x2_bwd_plain`. A CUDA tensor (float32 or
    bfloat16, contiguous) goes to the CUDA kernel, or raises; each launch adds
    one to `downfirdn2d_x2_bwd.launches`.
    """
    if dy.ndim != 4:
        raise ValueError(f"downfirdn2d_x2_bwd needs NCHW, got shape {tuple(dy.shape)}")
    if not _on_cuda(dy, "downfirdn2d_x2_bwd"):
        return downfirdn2d_x2_bwd_plain(dy, f)
    N, C, Ho, Wo = dy.shape
    dx = torch.empty((N, C, 2 * Ho, 2 * Wo), dtype=dy.dtype, device=dy.device)
    _launch(downfirdn2d_x2_bwd, dy, dx, f, 2 * Ho, 2 * Wo)
    return dx


downfirdn2d_x2_bwd.launches = 0


class _DownFirX2(torch.autograd.Function):
    """K1 with a gradient: forward `downfirdn2d_x2`, backward `_UpFirX2`.

    Both directions launch on the current stream, which the autograd engine
    sets to the forward's stream for the backward. An incoming gradient may
    be non-contiguous (cuDNN's need not be), so it is made contiguous first.
    """

    @staticmethod
    def forward(ctx, x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        ctx.f = f
        return downfirdn2d_x2(x, f)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        return _UpFirX2.apply(dy.contiguous(), ctx.f), None


class _UpFirX2(torch.autograd.Function):
    """K1-bwd with a gradient: forward `downfirdn2d_x2_bwd`, backward `_DownFirX2`."""

    @staticmethod
    def forward(ctx, dy: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        ctx.f = f
        return downfirdn2d_x2_bwd(dy, f)

    @staticmethod
    def backward(ctx, ddx: torch.Tensor):
        return _DownFirX2.apply(ddx.contiguous(), ctx.f), None
