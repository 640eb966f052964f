"""Hyperparameter-sweep launcher of the port (reference
src/infra/slurm_batch_launch.py).

Reads a sweep file (default configs/experiments.yaml) of the form

    <group>:
      common_args:            # overrides shared by every experiment in the group
        training.batch_size: 16
      experiments:
        <exp_name>: {}        # name only -> exp_suffix
        <exp_name2>:
          model.generator.time_enc.min_period_len: 32

and runs (or prints, --print-only) one `python -m stylegan_v_tpu_torch.launch`
per (dataset x experiment), merging common_args <- experiment overrides <-
--extra overrides (reference slurm_batch_launch.py:14-45), as
scripts/batch_launch.py does for the JAX package. `--device` (default cuda;
no card raises, `--device cpu` runs on the CPU) goes to every launch.

    python -m stylegan_v_tpu_torch.batch_launch --group mocogan_baseline \\
        --datasets ffs,sky_timelapse --print-only
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def construct_experiment_args(group_cfg: dict, experiments_list=None,
                              suffix: str = "") -> List[Dict]:
    """Merge common_args with per-experiment overrides; one dict per
    experiment (reference slurm_batch_launch.py:35-45)."""
    common = dict(group_cfg.get("common_args") or {})
    out = []
    for name, exp_cfg in (group_cfg.get("experiments") or {}).items():
        if experiments_list is not None and name not in experiments_list:
            continue
        merged = {**common, **(exp_cfg or {})}
        merged["exp_suffix"] = f"{name}{suffix}"
        out.append(merged)
    return out


def main(argv: Optional[List[str]] = None) -> List[List[str]]:
    """The CLI; returns the launch commands."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--sweep-file", default=os.path.join(REPO, "configs", "experiments.yaml"))
    ap.add_argument("--group", required=True, help="top-level group in the sweep file")
    ap.add_argument("--datasets", required=True, help="comma-separated dataset config names")
    ap.add_argument("--experiments", default=None,
                    help="comma-separated subset of experiment names")
    ap.add_argument("--suffix", default="", help="appended to each exp_suffix")
    ap.add_argument("--extra", nargs="*", default=[],
                    help="extra key=value overrides applied to every job")
    ap.add_argument("--print-only", action="store_true")
    ap.add_argument("--allow-dirty", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (the default), cuda:N or cpu")
    args = ap.parse_args(argv)

    import yaml

    from .training.loop import resolve_device

    resolve_device(args.device)
    with open(args.sweep_file) as f:
        sweep = yaml.safe_load(f)
    if args.group not in sweep:
        raise SystemExit(f"unknown group {args.group!r}; available: {sorted(sweep)}")
    exp_filter = args.experiments.split(",") if args.experiments else None
    exp_dicts = construct_experiment_args(sweep[args.group], exp_filter, args.suffix)
    if not exp_dicts:
        raise SystemExit("no experiments matched")

    cmds = []
    for dataset in args.datasets.split(","):
        for exp in exp_dicts:
            cmd = [sys.executable, "-m", "stylegan_v_tpu_torch.launch", f"dataset={dataset}"]
            cmd += [f"{k}={v}" for k, v in exp.items()] + list(args.extra)
            cmd += ["--device", args.device] + (["--allow-dirty"] if args.allow_dirty else [])
            cmds.append(cmd)
            if args.print_only:
                print(" ".join(cmd))
                continue
            print(f"[batch_launch] {' '.join(cmd)}", flush=True)
            ret = subprocess.run(cmd, cwd=REPO).returncode
            if ret != 0:
                print(f"[batch_launch] job failed with {ret}; continuing", flush=True)
    return cmds


if __name__ == "__main__":
    main()
