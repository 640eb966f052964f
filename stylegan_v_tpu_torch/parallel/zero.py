"""ZeRO-1: Adam's moments partitioned over the ranks.

The port's counterpart of stylegan_v_tpu/parallel/zero.py, where the moments
are sharded along the mesh's data axis and XLA gathers the update. Here
`torch.distributed.optim.ZeroRedundancyOptimizer` wraps Adam: each rank
keeps the moments of, and updates, its share of the parameters (whole
tensors, assigned by size), then broadcasts them, so every rank ends the
step with every parameter. Adam's update is elementwise, so the parameters
equal plain Adam's to the bit. With one rank it is plain Adam.

A snapshot needs the whole optimizer state on rank 0:
`consolidate_optimizers_` gathers it there (a collective: every rank calls
it), and the optimizer's `state_dict()` then reads it on rank 0.
"""
from __future__ import annotations

from typing import Iterable

import torch

from .distributed import World


def make_adam(params: Iterable[torch.Tensor], lr: float, betas, eps: float,
              world: World, zero1: bool = False) -> torch.optim.Optimizer:
    """Adam over `params`, partitioned over the ranks with ZeRO-1 when `zero1`
    and there is more than one rank."""
    params = list(params)
    if zero1 and world.size > 1:
        from torch.distributed.optim import ZeroRedundancyOptimizer
        return ZeroRedundancyOptimizer(params, optimizer_class=torch.optim.Adam,
                                       lr=lr, betas=betas, eps=eps)
    return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps)


def is_zero(opt: torch.optim.Optimizer) -> bool:
    from torch.distributed.optim import ZeroRedundancyOptimizer
    return isinstance(opt, ZeroRedundancyOptimizer)


def local_optimizer(opt: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """The optimizer that holds this rank's moments (ZeRO's inner Adam)."""
    return opt.optim if is_zero(opt) else opt


def opt_state_bytes_per_device(state) -> int:
    """The bytes of optimizer state (Adam's moments and steps) this rank holds."""
    total = 0
    for opt in (state.opt_G, state.opt_D):
        for per_param in local_optimizer(opt).state.values():
            total += sum(v.numel() * v.element_size() for v in per_param.values()
                         if isinstance(v, torch.Tensor))
    return total


def consolidate_optimizers_(state, to: int = 0) -> None:
    """Gather each ZeRO optimizer's whole state on rank `to`; every rank must
    call it. Plain Adam has nothing to gather."""
    for opt in (state.opt_G, state.opt_D):
        if is_zero(opt):
            opt.consolidate_state_dict(to=to)
