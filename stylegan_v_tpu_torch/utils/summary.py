"""Model summaries for nn.Modules (reference torch_utils/misc.py:193-272's
startup wiring check); the port's counterpart of the JAX package's
stylegan_v_tpu/utils/summary.py.

  * print_module_summary — parameter and buffer table of a module;
  * print_activation_summary — per-submodule output shapes from a dummy
    forward, read by forward hooks as the original's summary did;
  * check_replica_consistency — every rank holds the same replicated state
    (stylegan_v_tpu/utils/summary.py:112-142; reference misc.py:179-188).
"""
from __future__ import annotations

import hashlib
import re
from typing import Dict, List, Mapping, Optional

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


def _named_tensors(tree, prefix: str = ""):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _named_tensors(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_tensors(v, f"{prefix}/{i}")
    elif isinstance(tree, (int, float)):
        yield prefix, torch.tensor(tree, dtype=torch.float64)


def tree_content_hash(tree, ignore_regex: Optional[str] = None) -> str:
    """md5 over the names and bytes of every tensor in a nest of dicts and
    lists (numbers count as float64), in name order."""
    pat = re.compile(ignore_regex) if ignore_regex else None
    h = hashlib.md5()
    for name, t in sorted(_named_tensors(tree), key=lambda kv: kv[0]):
        if pat and pat.search(name):
            continue
        h.update(name.encode())
        h.update(t.detach().reshape(-1).cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def train_state_tree(state) -> Dict:
    """What a TrainState replicates on every rank: G, D and G_ema (parameters
    and buffers), Adam's moments unless ZeRO-1 partitions them, each Adam
    parameter group's lr, the device scalars and the counters."""
    from ..parallel.zero import is_zero
    tree = {"G": state.G.state_dict(), "D": state.D.state_dict(),
            "G_ema": state.G_ema.state_dict(), "pl_mean": state.pl_mean,
            "augment_p": state.augment_p, "ada_sign_acc": state.ada_sign_acc,
            "step": state.step, "cur_nimg": state.cur_nimg}
    for name in ("opt_G", "opt_D"):
        opt = getattr(state, name)
        tree[f"{name}_lr"] = [g["lr"] for g in opt.param_groups]
        if not is_zero(opt):            # ZeRO-1's moments are this rank's share
            tree[name] = {str(i): s for i, s in enumerate(opt.state.values())}
    return tree


def check_replica_consistency(tree, world=None, ignore_regex: Optional[str] = None) -> bool:
    """Every rank must hold the same replicated state (call before a
    snapshot): each rank hashes `tree` (tensors in a nest of dicts and lists,
    on any device; `train_state_tree` gives a TrainState's), the digests are
    gathered as host objects, and a divergence raises on every rank
    together. One rank: trivially true. `ignore_regex` drops tensor names
    (`/`-joined keys) that may legitimately differ."""
    from ..parallel.distributed import world as current_world
    world = current_world() if world is None else world
    if world.size == 1:
        return True
    import torch.distributed as dist
    digests = [None] * world.size
    dist.all_gather_object(digests, tree_content_hash(tree, ignore_regex))
    if len(set(digests)) != 1:
        diverged = [r for r, d in enumerate(digests) if d != digests[0]]
        raise RuntimeError(f"replicated training state diverged across ranks: rank(s) "
                           f"{diverged} differ from rank 0 (the reference's "
                           f"check_ddp_consistency failing)")
    return True
