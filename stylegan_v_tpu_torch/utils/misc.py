"""Small runtime utilities; the PyTorch counterpart of stylegan_v_tpu/utils/misc.py.

  * EasyDict       — dict with attribute access (reference dnnlib/util.py:40)
  * assert_shape   — shape check with None wildcards (reference torch_utils/misc.py:80)
  * format_time    — human readable elapsed time (reference dnnlib/util.py:142)
  * parse_scaling  — up/down factor -> [x, y] (reference ops/upfirdn2d.py:22-30)
  * parse_padding  — padding -> [x0, x1, y0, y1] (reference ops/upfirdn2d.py:33-44)
  * normal_param   — a parameter drawn from an explicit torch.Generator
  * float32_precision — TF32 allowed or not for float32 convs and matmuls, in a block
"""
from __future__ import annotations

import contextlib
from typing import Any, List, Optional, Sequence

import torch


class EasyDict(dict):
    """dict with attribute access."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        del self[name]


def assert_shape(x: torch.Tensor, ref_shape: Sequence[Optional[int]]) -> None:
    """Assert that a tensor matches the given shape; None entries are wildcards."""
    if x.ndim != len(ref_shape):
        raise AssertionError(f"Wrong number of dimensions: got {x.ndim}, expected {len(ref_shape)}")
    for idx, (size, ref_size) in enumerate(zip(x.shape, ref_shape)):
        if ref_size is not None and int(size) != int(ref_size):
            raise AssertionError(f"Wrong size for dimension {idx}: got {size}, expected {ref_size}")


def format_time(seconds: float) -> str:
    """Human readable elapsed time; mirrors reference dnnlib/util.py:142-153."""
    s = int(round(seconds))
    if s < 60:
        return f"{s}s"
    if s < 60 * 60:
        return f"{s // 60}m {s % 60:02d}s"
    if s < 24 * 60 * 60:
        return f"{s // (60 * 60)}h {(s // 60) % 60:02d}m {s % 60:02d}s"
    return f"{s // (24 * 60 * 60)}d {(s // (60 * 60)) % 24:02d}h {(s // 60) % 60:02d}m"


def parse_scaling(scaling) -> List[int]:
    if isinstance(scaling, int):
        scaling = [scaling, scaling]
    sx, sy = scaling
    assert sx >= 1 and sy >= 1
    return [int(sx), int(sy)]


def parse_padding(padding) -> List[int]:
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = list(padding)
    if len(padding) == 2:
        px, py = padding
        padding = [px, px, py, py]
    px0, px1, py0, py1 = padding
    return [int(px0), int(px1), int(py0), int(py1)]


def normal_param(shape, generator: Optional[torch.Generator],
                 std: float = 1.0) -> torch.nn.Parameter:
    """float32 parameter ~ N(0, std^2) drawn from `generator` on the CPU.

    With generator=None the parameter is left uninitialised, for a module
    whose weights come from `load_state_dict`; nothing draws from the global
    RNG.
    """
    if generator is None:
        return torch.nn.Parameter(torch.empty(shape, dtype=torch.float32))
    w = torch.randn(shape, generator=generator, dtype=torch.float32) * std
    return torch.nn.Parameter(w)


@contextlib.contextmanager
def float32_precision(allow_tf32: bool = False):
    """Run the block with TF32 allowed or not for cuDNN's float32 convolutions
    and for float32 matmuls, then restore the caller's settings, whether the
    block returns or raises. Usable as a decorator.

    PyTorch lets cuDNN run float32 convolutions in TF32 by default (10-bit
    mantissas); the original's training loop turns it off unless asked
    (its `allow_tf32` option). The two single attributes are set and read
    back: `torch.backends.cudnn.flags(...)` would also reset `enabled`,
    whose default there is False. Where torch has the `fp32_precision`
    settings, these attributes drive them.
    """
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = allow_tf32
        if (cudnn.allow_tf32, matmul.allow_tf32) != (allow_tf32, allow_tf32):
            raise RuntimeError(f"torch did not take allow_tf32={allow_tf32}: cudnn "
                               f"{cudnn.allow_tf32}, matmul {matmul.allow_tf32}")
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
