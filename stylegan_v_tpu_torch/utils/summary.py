"""Model summaries for nn.Modules (reference torch_utils/misc.py:193-272's
startup wiring check); the port's counterpart of the JAX package's
stylegan_v_tpu/utils/summary.py.

  * print_module_summary — parameter and buffer table of a module;
  * print_activation_summary — per-submodule output shapes from a dummy
    forward, read by forward hooks as the original's summary did.

The JAX package's check_replica_consistency belongs to multi-GPU training
(ROADMAP P8) and is not ported yet.
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn


def module_summary_rows(module: nn.Module) -> List[Dict]:
    rows = [dict(collection="params", name=n, shape=tuple(p.shape), params=p.numel())
            for n, p in module.named_parameters()]
    rows += [dict(collection="buffers", name=n, shape=tuple(b.shape), params=b.numel())
             for n, b in module.named_buffers()]
    return rows


def print_module_summary(module: nn.Module, title: str = "Module", max_rows: int = 200,
                         log=print) -> int:
    """Print the parameter table; returns total parameter count."""
    rows = module_summary_rows(module)
    total = sum(r["params"] for r in rows if r["collection"] == "params")
    if max_rows <= 0:      # summary line only
        log(f"{title}: {total / 1e6:.2f}M parameters in {len(rows)} tensors")
        return total
    w = max((len(r["name"]) for r in rows), default=10) + 2
    log(f"\n{title}  —  {total / 1e6:.2f}M parameters")
    log(f"{'Name':<{w}}{'Shape':<24}{'Params':>12}  Collection")
    log("-" * (w + 48))
    for r in rows[:max_rows]:
        log(f"{r['name']:<{w}}{str(r['shape']):<24}{r['params']:>12,}  "
            f"{r['collection']}")
    if len(rows) > max_rows:
        log(f"... ({len(rows) - max_rows} more rows)")
    log("-" * (w + 48))
    log(f"{'Total':<{w}}{'':<24}{total:>12,}")
    return total


def activation_summary_rows(module: nn.Module, *args, **kwargs) -> List[Dict]:
    """Per-submodule OUTPUT shapes and dtypes from one forward of `module` on
    `args`, without gradients, in the order the submodules return."""
    rows: List[Dict] = []

    def record(name):
        def hook(_mod, _inputs, out):
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for o in outs:
                if isinstance(o, torch.Tensor):
                    rows.append(dict(name=name or "(root)", shape=tuple(o.shape),
                                     dtype=str(o.dtype).replace("torch.", "")))
        return hook

    handles = [m.register_forward_hook(record(n)) for n, m in module.named_modules()]
    try:
        with torch.no_grad():
            module(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    return rows


def print_activation_summary(module: nn.Module, *args, title: str = "Module", log=print,
                             **kwargs) -> List[Dict]:
    """Print the per-submodule output-shape table for a dummy forward."""
    rows = activation_summary_rows(module, *args, **kwargs)
    w = max((len(r["name"]) for r in rows), default=10) + 2
    log(f"\n{title} activations (dummy forward)")
    log(f"{'Module':<{w}}{'Output shape':<26}Dtype")
    log("-" * (w + 36))
    for r in rows:
        log(f"{r['name']:<{w}}{str(r['shape']):<26}{r['dtype']}")
    log("-" * (w + 36))
    return rows
