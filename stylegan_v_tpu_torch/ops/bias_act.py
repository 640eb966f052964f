"""Fused bias + activation + gain + clamp, plain PyTorch.

Counterpart of stylegan_v_tpu/ops/bias_act.py (reference
src/torch_utils/ops/bias_act.py). The bias runs along `dim`, 1 by default
for NCHW. The clamp's gradient is zero beyond the bounds and one half where
the input equals a bound, as the JAX package's `jnp.clip` gives it (a
`torch.clamp` would pass all of it there). The lrelu's gradient is 1 where
the input is exactly 0, as `jax.nn.leaky_relu`'s is (`F.leaky_relu` would
pass the slope there): see `leaky_relu`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..utils.misc import EasyDict


class _LeakyReLU(torch.autograd.Function):
    """F.leaky_relu's value with jax.nn.leaky_relu's gradient,
    g * where(x >= 0, 1, alpha): 1 at x == 0 (and -0.0), where torch passes
    the slope. The backward is `leaky_relu_backward` (g where its second
    argument is positive, else alpha g) on heaviside(x, 1), which is 1 where
    x >= 0 and 0 below, in x's dtype so that both passes stay vectorised: one
    pass more than torch's own. It is linear in g, so a second order
    differentiates it again, and its derivative in x is 0, as in JAX."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, alpha: float) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.alpha = alpha
        return F.leaky_relu(x, alpha)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, = ctx.saved_tensors
        step = torch.heaviside(x.detach(), torch.ones((), dtype=x.dtype))   # CPU scalar one
        return torch.ops.aten.leaky_relu_backward(g, step, ctx.alpha, False), None


def leaky_relu(x: torch.Tensor, alpha: float = 0.2) -> torch.Tensor:
    """Leaky ReLU with the JAX package's gradient at 0 (see `_LeakyReLU`)."""
    return _LeakyReLU.apply(x, float(alpha))


# Activation registry; def_gain/def_alpha mirror reference bias_act.py:23-33.
activation_funcs = {
    'linear':   EasyDict(func=lambda x, **_: x, def_alpha=0.0, def_gain=1.0),
    'relu':     EasyDict(func=lambda x, **_: F.relu(x), def_alpha=0.0, def_gain=math.sqrt(2)),
    'lrelu':    EasyDict(func=lambda x, alpha, **_: leaky_relu(x, alpha),
                         def_alpha=0.2, def_gain=math.sqrt(2)),
    'tanh':     EasyDict(func=lambda x, **_: torch.tanh(x), def_alpha=0.0, def_gain=1.0),
    'sigmoid':  EasyDict(func=lambda x, **_: torch.sigmoid(x), def_alpha=0.0, def_gain=1.0),
    'elu':      EasyDict(func=lambda x, **_: F.elu(x), def_alpha=0.0, def_gain=1.0),
    'selu':     EasyDict(func=lambda x, **_: F.selu(x), def_alpha=0.0, def_gain=1.0),
    'softplus': EasyDict(func=lambda x, **_: F.softplus(x), def_alpha=0.0, def_gain=1.0),
    'swish':    EasyDict(func=lambda x, **_: torch.sigmoid(x) * x,
                         def_alpha=0.0, def_gain=math.sqrt(2)),
}


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None, dim: int = 1,
             act: str = 'linear', alpha: Optional[float] = None,
             gain: Optional[float] = None, clamp: Optional[float] = None) -> torch.Tensor:
    """Bias-add, activation, gain, clamp (reference bias_act.py:55-89).

    Args:
        x:     input of any shape.
        b:     optional 1-D bias broadcast along `dim`.
        dim:   dimension carrying channels (1 for NCHW).
        act:   key into `activation_funcs`.
        alpha: activation shape parameter (lrelu slope); None = registry default.
        gain:  post-activation scale; None = registry default (sqrt(2) for [l]relu).
        clamp: clip output to [-clamp, clamp]; None = no clamping.
    """
    spec = activation_funcs[act]
    alpha = float(spec.def_alpha) if alpha is None else float(alpha)
    gain = float(spec.def_gain) if gain is None else float(gain)
    if clamp is not None:
        assert clamp >= 0

    if b is not None:
        assert b.ndim == 1, f"bias must be 1-D, got {tuple(b.shape)}"
        assert b.shape[0] == x.shape[dim]
        shape = [1] * x.ndim
        shape[dim] = -1
        x = x + b.reshape(shape).to(x.dtype)

    x = spec.func(x, alpha=alpha)

    if gain != 1.0:
        x = x * float(torch.tensor(gain, dtype=x.dtype))   # gain rounded to x's dtype
    if clamp is not None:
        bound = torch.tensor(float(clamp), dtype=x.dtype)     # a CPU scalar operand
        x = torch.minimum(torch.maximum(x, -bound), bound)
    return x
