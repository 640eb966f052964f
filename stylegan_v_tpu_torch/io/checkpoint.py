"""Checkpoint save/restore for the port's whole TrainState, with torch.save.

The port's counterpart of stylegan_v_tpu/io/checkpoint.py (an Orbax pytree
there). As there, the snapshot embeds the model CONFIGS rather than module
source (the reference's persistence.py:103-116 init-args capture), so it is
self-describing and restorable without the original config files.

Layout:  <run_dir>/network-snapshot-<kimg>.pt         (torch.save)
         <run_dir>/network-snapshot-<kimg>.meta.json  (configs and counters,
                                                       as the JAX package writes it)
The .pt file holds CPU copies of G, D and G_ema (parameters and buffers,
w_avg included), both Adams' state_dicts, pl_mean, augment_p, ada_sign_acc,
step and cur_nimg. Resume modes mirror the reference (train.py:283-317,
training_loop.py:167-183): resume='latest' scans run_dir for the newest
snapshot; `restore_train_state` puts the whole state back (counters, Adam's
moments, ADA's p); `copy_params` is the name- and shape-matched partial copy
for transfer learning.

Over several ranks, rank 0 alone writes a snapshot, after
parallel/zero.py:consolidate_optimizers_ has gathered ZeRO-1's moments there
(every rank calls it); every rank reads it on resume, and ZeRO-1 keeps its
share of the moments. A snapshot's optimizer state has the same layout with
or without ZeRO-1.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from ..models.config import (DiscriminatorConfig, GeneratorConfig, MotionConfig,
                             SamplingConfig, TimeEncConfig)

SNAPSHOT_RE = re.compile(r"network-snapshot-(\d+)\.pt$")
CONFIG_REGISTRY = {cls.__name__: cls for cls in (GeneratorConfig, DiscriminatorConfig,
                                                 MotionConfig, TimeEncConfig, SamplingConfig)}


def _to_cpu(tree):
    """A copy of every tensor in a nest of dicts and lists, on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _meta_encode(obj):
    if dataclasses.is_dataclass(obj):
        # NOTE: not dataclasses.asdict — it recursively flattens nested
        # dataclasses and loses their types; encode each field explicitly.
        return {"__dataclass__": type(obj).__name__,
                "fields": {f.name: _meta_encode(getattr(obj, f.name))
                           for f in dataclasses.fields(obj)}}
    if isinstance(obj, tuple):
        return [_meta_encode(v) for v in obj]
    return obj


def meta_decode(node, registry: Optional[Dict[str, Any]] = None):
    """Inverse of _meta_encode: rebuild dataclasses via a name->class registry
    (the port's config classes by default)."""
    registry = CONFIG_REGISTRY if registry is None else registry
    if isinstance(node, dict) and "__dataclass__" in node:
        cls = registry[node["__dataclass__"]]
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: meta_decode(v, registry) for k, v in node["fields"].items() if k in names}
        kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in kw.items()}
        return cls(**kw)
    if isinstance(node, dict):
        return {k: meta_decode(v, registry) for k, v in node.items()}
    return node


def snapshot_payload(state) -> Dict[str, Any]:
    """CPU copies of everything a TrainState holds (the .pt file's content)."""
    return _to_cpu({
        "G": state.G.state_dict(), "D": state.D.state_dict(),
        "G_ema": state.G_ema.state_dict(),
        "opt_G": state.opt_G.state_dict(), "opt_D": state.opt_D.state_dict(),
        "pl_mean": state.pl_mean, "augment_p": state.augment_p,
        "ada_sign_acc": state.ada_sign_acc,
        "step": int(state.step), "cur_nimg": int(state.cur_nimg)})


def save_snapshot(run_dir: str, state, cur_nimg: int, configs: Dict[str, Any],
                  extra_meta: Optional[Dict] = None) -> str:
    """Write network-snapshot-<kimg>.pt and its .meta.json (reference
    network-snapshot-XXXXXX naming); returns the .pt path."""
    stem = os.path.abspath(os.path.join(run_dir, f"network-snapshot-{cur_nimg // 1000:06d}"))
    os.makedirs(run_dir, exist_ok=True)
    tmp = stem + ".pt.tmp"
    torch.save(snapshot_payload(state), tmp)
    os.replace(tmp, stem + ".pt")
    meta = {
        "cur_nimg": int(cur_nimg),
        "configs": {k: _meta_encode(v) for k, v in configs.items()},
    }
    if extra_meta:
        meta.update(extra_meta)
    with open(stem + ".meta.json", "w") as f:
        json.dump(meta, f, indent=2, default=str)
    return stem + ".pt"


def find_latest_snapshot(run_dir: str) -> Optional[str]:
    """resume='latest' scan (reference train.py:298-309)."""
    if not os.path.isdir(run_dir):
        return None
    best, best_kimg = None, -1
    for name in os.listdir(run_dir):
        m = SNAPSHOT_RE.match(name)
        if m and os.path.isfile(os.path.join(run_dir, name)):
            kimg = int(m.group(1))
            if kimg > best_kimg:
                best, best_kimg = os.path.join(run_dir, name), kimg
    return best


def load_snapshot(path: str, map_location="cpu") -> Tuple[Dict[str, Any], Dict]:
    """Read a snapshot's payload (tensors on `map_location`) and its meta."""
    payload = torch.load(path, map_location=map_location, weights_only=True)
    meta = {}
    meta_path = re.sub(r"\.pt$", "", path) + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return payload, meta


def _packed_param_groups(opt: torch.optim.Optimizer):
    """opt's param_groups as its state_dict() packs them (parameters by
    index); ZeRO-1's state_dict() needs a consolidation first, this does not."""
    groups, start = [], 0
    for g in opt.param_groups:
        packed = {k: v for k, v in g.items() if k != "params"}
        packed["params"] = list(range(start, start + len(g["params"])))
        start += len(g["params"])
        groups.append(packed)
    return groups


def load_adam_state(opt: torch.optim.Optimizer, per_param: Mapping[int, Any]) -> None:
    """Adam's per-parameter state (step, exp_avg, exp_avg_sq by parameter
    index) into `opt`, plain Adam or ZeRO-1 (which keeps this rank's share);
    lr and betas stay the ones the optimizer was built with, from the run's
    config, as optax's do. The optimizer gets copies: it updates its moments
    in place, and `per_param` stays as it was."""
    opt.load_state_dict({"state": copy.deepcopy(dict(per_param)),
                         "param_groups": _packed_param_groups(opt)})


def restore_train_state(state, payload: Mapping[str, Any]):
    """Put a snapshot's whole state into `state`, on its device: G, D and
    G_ema, both Adams, the device scalars and the counters."""
    device = state.pl_mean.device
    state.G.load_state_dict(payload["G"])
    state.D.load_state_dict(payload["D"])
    state.G_ema.load_state_dict(payload["G_ema"])
    load_adam_state(state.opt_G, payload["opt_G"]["state"])
    load_adam_state(state.opt_D, payload["opt_D"]["state"])
    for k in ("pl_mean", "augment_p", "ada_sign_acc"):
        setattr(state, k, payload[k].to(device, torch.float32))
    state.step, state.cur_nimg = int(payload["step"]), int(payload["cur_nimg"])
    return state


def copy_params(src: Mapping[str, torch.Tensor], dst: Mapping[str, torch.Tensor],
                require_all: bool = False) -> Dict[str, torch.Tensor]:
    """Name-matched partial parameter copy for transfer learning
    (reference misc.copy_params_and_buffers, misc.py:146-161).

    Copies the entries of `src` whose names exist in `dst` with the same
    shape, in dst's dtype; entries only in dst are kept as they are
    (require_all=False) or raise."""
    out = {}
    for name, d in dst.items():
        s = src.get(name)
        if s is not None and tuple(s.shape) == tuple(d.shape):
            out[name] = s.detach().to(d.dtype).clone()
        elif require_all:
            raise KeyError(f"missing parameter {name} in source checkpoint")
        else:
            out[name] = d
    return out
