"""Training entry point of the port.

    python -m stylegan_v_tpu_torch.train dataset=ffs dataset.path=/data/ffs_256.zip \\
        training.batch_size=16 exp_suffix=myrun

    python -m stylegan_v_tpu_torch.train --cfg-path runs/exp/experiment_config.yaml

The counterpart of the repo's root train.py (the JAX package's): it composes
configs/ groups with dotted overrides (or reads a frozen config), freezes the
resolved config to <run_dir>/experiment_config.yaml (what makes
resume=latest work), probes the dataset's resolution and labels, resolves
the setup and runs the training loop on `--device` (default cuda; there is
no fallback to the CPU: pass --device cpu for a CPU run). After each
snapshot the loop scores `training.metrics` (configs/training/base.yaml lists
four FVD and FID metrics) with the detectors found in $SGV_DETECTOR_DIR or
./detectors; `training.metric_kwargs.<key>=<value>` passes keyword arguments
to calc_metric (max_real_override, num_gen_override, cache_dir, ...), and
training.metrics=[] turns them off.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def main(argv: Optional[List[str]] = None) -> Optional[Dict]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("overrides", nargs="*", help="group=option or a.b.c=value")
    ap.add_argument("--config-dir", default=CONFIG_DIR)
    ap.add_argument("--cfg-path", default=None,
                    help="frozen experiment_config.yaml (skips composition)")
    ap.add_argument("--device", default="cuda", help="cuda (the default), cuda:N or cpu")
    args = ap.parse_args(argv)

    import torch

    from .data import VideoFramesFolderDataset
    from .train_setup import _sampling_from_cfg, setup_training
    from .training.loop import resolve_device, training_loop
    from .utils import config as cfglib

    device = resolve_device(args.device)
    if args.cfg_path:
        cfg = cfglib.load_frozen(args.cfg_path)
        for ov in args.overrides:
            key, val = ov.split("=", 1)
            cfglib.set_by_path(cfg, key, cfglib._parse_value(val))
        run_dir = cfg.get("project_release_dir") if any(
            o.startswith("project_release_dir=") for o in args.overrides) \
            else os.path.dirname(os.path.abspath(args.cfg_path))
    else:
        cfg = cfglib.load_config(args.config_dir, args.overrides)
        run_dir = cfg.get("project_release_dir", "runs/exp")
    os.makedirs(run_dir, exist_ok=True)
    cfglib.save(cfg, os.path.join(run_dir, "experiment_config.yaml"))

    # probe dataset resolution/labels (reference train.py:100-106)
    data_path = cfg.training.get("data", cfg.dataset.path)
    probe = VideoFramesFolderDataset(
        data_path, sampling=_sampling_from_cfg(dict(cfg.sampling)),
        max_num_frames=int(cfg.dataset.get("max_num_frames", 1024)),
        use_labels=bool(cfg.training.get("cond", False)))
    resolution, c_dim = probe.resolution, (probe.label_dim if probe.has_labels else 0)
    probe.close()

    if cfg.training.get("debug_nans"):
        # NaN tracking during debugging (the JAX package's jax_debug_nans)
        torch.autograd.set_detect_anomaly(True)

    setup = setup_training(cfg, dataset_resolution=resolution,
                           dataset_c_dim=c_dim, run_dir=run_dir)

    if cfg.training.get("dry_run"):
        print("Dry run: configuration is valid.")
        print(f"  run_dir: {setup.run_dir}")
        print(f"  desc: {setup.desc}")
        print(f"  batch_size: {setup.train_cfg.batch_size}  "
              f"kimg: {setup.total_kimg}  r1_gamma: {setup.loss_cfg.r1_gamma}")
        return None

    return training_loop(setup, device=device)


if __name__ == "__main__":
    main()
