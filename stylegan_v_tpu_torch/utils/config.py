"""Layered YAML config system (Hydra-lite).

Capability parity with the reference's Hydra/OmegaConf stack
(reference configs/config.yaml, src/infra/launch.py) without the hydra
dependency (not in this image):

  * group composition: configs/config.yaml lists defaults like
    `- model: stylegan-v`; each resolves to configs/<group>/<option>.yaml;
  * ${a.b.c} interpolation across the merged tree (e.g. the reference's
    `motion_z_distance: ${model.generator.time_enc.min_period_len}` coupling);
  * CLI override grammar: `group=option` swaps a group file,
    `a.b.c=value` sets a leaf (YAML-parsed scalars);
  * frozen-config snapshot: `save(cfg, path)` writes the fully-resolved
    experiment_config.yaml consumed by train.py (the reference's
    launch.py:35,64-67 -> train.py:392 contract).

A copy of stylegan_v_tpu/utils/config.py that imports PyYAML at first use,
not at import (tests/test_torch_data.py holds the two equal on configs/).
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

from .misc import EasyDict

_INTERP_RE = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


def _to_easy(obj):
    if isinstance(obj, dict):
        return EasyDict({k: _to_easy(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_to_easy(v) for v in obj]
    return obj


def _to_plain(obj):
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_plain(v) for v in obj]
    return obj


def _merge(dst: Dict, src: Dict) -> Dict:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], dict) and isinstance(v, dict):
            _merge(dst[k], v)
        else:
            dst[k] = v
    return dst


def _lookup(tree: Dict, dotted: str):
    node = tree
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            raise KeyError(f"interpolation target not found: {dotted}")
        node = node[part]
    return node


_ROOT = object()   # sentinel: YAML null leaves are legitimate None values


def _resolve(tree: Dict, node=_ROOT, depth: int = 0):
    """Recursively resolve ${...} interpolations against the root tree."""
    if depth > 16:
        raise RecursionError("interpolation cycle detected")
    if node is _ROOT:
        node = tree
    if isinstance(node, dict):
        return {k: _resolve(tree, v, depth) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve(tree, v, depth) for v in node]
    if isinstance(node, str):
        m = _INTERP_RE.fullmatch(node)
        if m:   # whole-string interpolation preserves type
            return _resolve(tree, _lookup(tree, m.group(1)), depth + 1)
        def sub(match):
            return str(_resolve(tree, _lookup(tree, match.group(1)), depth + 1))
        return _INTERP_RE.sub(sub, node)
    return node


def _yaml():
    import yaml
    return yaml


def _parse_value(text: str):
    yaml = _yaml()
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def set_by_path(tree: Dict, dotted: str, value) -> None:
    parts = dotted.split(".")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def load_config(config_dir: str, overrides: Optional[List[str]] = None,
                resolve: bool = True) -> EasyDict:
    """Compose configs/config.yaml + group files + CLI overrides."""
    overrides = list(overrides or [])
    yaml = _yaml()
    root_path = os.path.join(config_dir, "config.yaml")
    with open(root_path) as f:
        root = yaml.safe_load(f) or {}
    defaults = root.pop("defaults", [])

    # group selection from overrides: `group=option` (no dot in key)
    group_overrides = {}
    leaf_overrides = []
    for ov in overrides:
        assert "=" in ov, f"override must be key=value: {ov}"
        key, val = ov.split("=", 1)
        if "." not in key and os.path.isdir(os.path.join(config_dir, key)):
            group_overrides[key] = val
        else:
            leaf_overrides.append((key, val))

    tree: Dict = {}
    seen_groups = []
    for entry in defaults:
        if isinstance(entry, str):                       # "- group/file.yaml"
            path = os.path.join(config_dir, entry)
            group = os.path.dirname(entry) or None
        else:                                            # "- group: option"
            (group, option), = entry.items()
            if group.endswith(".yaml"):
                path = os.path.join(config_dir, group)
                group = os.path.dirname(group) or None
            else:
                option = group_overrides.get(group, option)
                path = os.path.join(config_dir, group, f"{option}.yaml")
        with open(path) as f:
            content = yaml.safe_load(f) or {}
        pkg = content.pop("__package__", group)          # like hydra @package
        if pkg:
            wrapped = {}
            set_by_path(wrapped, pkg, content)
            content = wrapped
        if group and group not in seen_groups:
            seen_groups.append(group)
        _merge(tree, content)

    _merge(tree, root)                                    # root-level keys
    for key, val in leaf_overrides:
        set_by_path(tree, key, _parse_value(val))
    if resolve:
        tree = _resolve(tree)
    return _to_easy(tree)


def load_frozen(path: str) -> EasyDict:
    """Read a fully-resolved experiment_config.yaml."""
    with open(path) as f:
        return _to_easy(_yaml().safe_load(f))


def save(cfg, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        _yaml().safe_dump(_to_plain(cfg), f, sort_keys=False)
