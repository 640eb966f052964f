"""A cell's specification: its entry of BENCHMARK.json, its configuration
file, its traffic file and its limits file, all found by name; and the
program's setup, composed by the program's own entry-point code.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
from typing import Any, Dict

from .traffic import BENCH_DIR, load_traffic

REPO_DIR = os.path.dirname(BENCH_DIR)


def _read(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, spec_path: str = None) -> Dict[str, Any]:
    """{"workload", "config", "traffic", "limits", "spec"} for the cell named
    `workload` in BENCHMARK.json (or `spec_path`, whose "limits_dir" may
    name another folder of limits than benchmark/limits)."""
    spec = _read(spec_path or os.path.join(REPO_DIR, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         f"{', '.join(sorted(cells))}")
    cell = cells[workload]
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])
    return {"workload": cell, "spec": spec,
            "config": _read(os.path.join(REPO_DIR, config["file"])),
            "traffic": load_traffic(cell["traffic"]),
            "limits": _read(os.path.join(REPO_DIR, spec.get("limits_dir", "benchmark/limits"),
                                         f"{workload}.json"))}


def load_mix(kind: str):
    """The module that drives a traffic file's `kind`: lib/<kind>_cell.py,
    with Program, run_program, checked_output, check, work, FAULTS and CHIPS
    (README.md)."""
    if not os.path.exists(os.path.join(BENCH_DIR, "lib", f"{kind}_cell.py")):
        raise SystemExit(f"no mix module benchmark/lib/{kind}_cell.py for traffic kind {kind!r}")
    return importlib.import_module(f"benchmark.lib.{kind}_cell")


def compose_setup(config: Dict[str, Any]):
    """The program's TrainSetup for a configuration file: the repository's
    configs/ composed with the file's overrides by the program's
    `utils/config.py:load_config`, resolved by `train_setup.py:setup_training`."""
    from stylegan_v_tpu_torch.train import CONFIG_DIR
    from stylegan_v_tpu_torch.train_setup import setup_training
    from stylegan_v_tpu_torch.utils import config as cfglib
    cfg = cfglib.load_config(CONFIG_DIR, list(config["overrides"]))
    return setup_training(cfg, dataset_resolution=config["clip"]["resolution"],
                          dataset_c_dim=0, run_dir=os.devnull)


def plain_setup(setup) -> Dict[str, Any]:
    """The resolved setup's values as plain data, which is all the reference
    and the traffic generator read of it."""
    def plain(x):
        return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x
    return {"gen_cfg": plain(setup.gen_cfg), "disc_cfg": plain(setup.disc_cfg),
            "loss_cfg": plain(setup.loss_cfg), "train_cfg": plain(setup.train_cfg),
            "opt_g": plain(setup.opt_g), "opt_d": plain(setup.opt_d),
            "augment_cfg": plain(setup.augment_cfg), "augment_p": setup.augment_p,
            "disc_source": setup.disc_source,
            "video_discr_lr_multiplier": setup.video_discr_lr_multiplier,
            "video_discr_num_t_paddings": setup.video_discr_num_t_paddings,
            "num_chips": setup.num_chips, "allow_tf32": setup.allow_tf32}


def check_resolved(plain: Dict[str, Any], config: Dict[str, Any]) -> None:
    """The values the configuration file states (its "resolved" section,
    dotted keys into `plain`) must be what the composition gave."""
    for key, want in config.get("resolved", {}).items():
        node = plain
        for part in key.split("."):
            node = node[part]
        if isinstance(want, float) or isinstance(node, float):
            ok = abs(float(node) - float(want)) <= 1e-9 * max(1.0, abs(float(want)))
        else:
            ok = node == want
        if not ok:
            raise SystemExit(f"configuration {config['name']}: {key} resolved to {node!r}, "
                             f"the file states {want!r}")
