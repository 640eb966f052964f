"""Weights from the seed, made on the device in one draw.

The benchmark builds the program's G and D (and, after the window, the
reference's) uninitialised, then fills every drawn leaf from one
`torch.randn` (and one `torch.rand`) of all the leaves' elements on the
card, with the law that the model's own constructors draw from:

  * equalised-LR weights N(0, 1), fully connected and 1-D conv weights
    N(0, 1/lr_multiplier^2), the generator's const input and the time
    encoder's embedding N(0, 1);
  * the MoCoGAN video D's Conv3d weights N(0, 0.02^2), its batch norms'
    scales 1 + N(0, 0.02^2);
  * the motion LSTM's weights and biases U(-1/sqrt(H), 1/sqrt(H)).

Every other leaf (biases, noise strengths) keeps the constant its
constructor set. The leaves are visited in `named_parameters` order, so the
same seed gives the same weights to the program and the reference, whose
modules are copies with the same class and parameter names.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Tuple

import torch

_NORMAL_UNIT = {("Conv2dLayer", "weight"), ("SynthesisLayer", "weight"),
                ("ToRGBLayer", "weight"), ("GenInput", "const"), ("Embedding", "weight")}
_NORMAL_LR = {("FullyConnectedLayer", "weight"), ("EqLRConv1d", "weight")}


def _rule(module: torch.nn.Module, name: str) -> Tuple[str, float, float]:
    """(law, scale, shift) of leaf `name` of `module`: ("normal", std, mean),
    ("uniform", bound, 0) or ("keep", 0, 0)."""
    kind = type(module).__name__
    if (kind, name) in _NORMAL_UNIT:
        return "normal", 1.0, 0.0
    if (kind, name) in _NORMAL_LR:
        return "normal", 1.0 / module.lr_multiplier, 0.0
    if kind == "_Conv3d" and name == "weight":
        return "normal", 0.02, 0.0
    if kind == "_BatchNorm3d" and name == "weight":
        return "normal", 0.02, 1.0
    if kind == "LSTM":
        return "uniform", 1.0 / math.sqrt(module.hidden_size), 0.0
    return "keep", 0.0, 0.0


def _leaves(modules: Iterable[torch.nn.Module]) -> List[Tuple[torch.Tensor, str, float, float]]:
    out = []
    for top in modules:
        for mod in top.modules():
            for name, p in mod.named_parameters(recurse=False):
                law, scale, shift = _rule(mod, name)
                if law != "keep":
                    out.append((p, law, scale, shift))
    return out


@torch.no_grad()
def init_from_seed(modules: Iterable[torch.nn.Module], seed: int) -> int:
    """Fill the drawn leaves of `modules` (on one device) from `seed`;
    returns the number of elements drawn."""
    leaves = _leaves(modules)
    if not leaves:
        return 0
    device = leaves[0][0].device
    gen = torch.Generator(device=device).manual_seed(seed)
    counts = {law: sum(p.numel() for p, l, _, _ in leaves if l == law)
              for law in ("normal", "uniform")}
    pools = {"normal": torch.randn(counts["normal"], generator=gen, device=device),
             "uniform": torch.rand(counts["uniform"], generator=gen, device=device)}
    offset = {"normal": 0, "uniform": 0}
    for p, law, scale, shift in leaves:
        chunk = pools[law][offset[law]:offset[law] + p.numel()].view_as(p)
        offset[law] += p.numel()
        if law == "normal":
            p.copy_(chunk * scale + shift)
        else:
            p.copy_(chunk * (2 * scale) - scale)
    return counts["normal"] + counts["uniform"]
