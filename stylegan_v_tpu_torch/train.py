"""Training entry point of the port.

    python -m stylegan_v_tpu_torch.train dataset=ffs dataset.path=/data/ffs_256.zip \\
        training.batch_size=16 exp_suffix=myrun

    python -m stylegan_v_tpu_torch.train --cfg-path runs/exp/experiment_config.yaml
    python -m stylegan_v_tpu_torch.train dataset.path=... --resume network-snapshot.pkl

The counterpart of the repo's root train.py (the JAX package's): it composes
configs/ groups with dotted overrides (or reads a frozen config), freezes the
resolved config to <run_dir>/experiment_config.yaml (what makes
resume=latest work; `--resume` sets training.resume: latest, a snapshot, or
a reference .pkl whose weights the run starts from), probes the dataset's
resolution and labels, resolves the setup and runs the training loop on
`--device` (default cuda; there is
no fallback to the CPU: pass --device cpu for a CPU run). After each
snapshot the loop scores `training.metrics` (configs/training/base.yaml lists
four FVD and FID metrics) with the detectors found in $SGV_DETECTOR_DIR or
./detectors; `training.metric_kwargs.<key>=<value>` passes keyword arguments
to calc_metric (max_real_override, num_gen_override, cache_dir, ...), and
training.metrics=[] turns them off.

Several devices (ROADMAP P8), one process each:

    python -m stylegan_v_tpu_torch.train num_gpus=2 ...      # spawns 2 ranks
    torchrun --nproc_per_node=2 -m stylegan_v_tpu_torch.train num_gpus=2 ...

`num_gpus=W` (configs/config.yaml) spawns W processes here, as the
reference's train.py did, or, under torchrun (RANK, WORLD_SIZE and
LOCAL_RANK in the environment), joins the ranks torchrun started. Rank r
trains on cuda:<local rank> (fewer cards than ranks raises), or every rank
on the one card `--device cuda:N` names, or on the CPU with `--device cpu`.
The backend is nccl on CUDA and gloo on the CPU; `--dist-backend gloo` runs
the ranks on CUDA over gloo, which is the only way for two ranks to share a
card (nccl refuses that). A rank that raises ends the others, and the run
exits non-zero. The CUDA kernels are built once before the ranks start.
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
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="the ranks' backend: nccl on CUDA and gloo on the CPU by default")
    ap.add_argument("--resume", default=None,
                    help="training.resume=<value>: latest, a snapshot (.pt), or a reference "
                         ".pkl (weights only)")
    args = ap.parse_intermixed_args(argv)          # overrides on both sides of the options
    if args.resume:
        args.overrides.append(f"training.resume={args.resume}")

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

    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:          # under torchrun
        return _run_rank(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://",
                         setup, str(device), args.dist_backend,
                         int(os.environ.get("LOCAL_RANK", 0)))
    W = setup.num_chips
    if W == 1:
        return training_loop(setup, device=device)
    if device.type == "cuda":
        if device.index is None and torch.cuda.device_count() < W:
            raise RuntimeError(f"num_gpus={W} but {torch.cuda.device_count()} CUDA "
                               f"device(s): pass --device cuda:N and --dist-backend gloo "
                               f"to run the ranks on one card")
        if device.index is not None and (args.dist_backend or "nccl") == "nccl":
            raise ValueError(f"{W} ranks on one card ({device}) need --dist-backend gloo: "
                             "nccl refuses two ranks on one device")
        from .ops.cuda_build import build_libraries
        build_libraries()                 # once, before the ranks start
    from .parallel.distributed import launch
    launch(_run_rank, W, args=(setup, str(device), args.dist_backend))
    return None


def _run_rank(rank: int, world_size: int, init_method: str, setup, device: str,
              backend: Optional[str], local_rank: Optional[int] = None) -> Optional[Dict]:
    """One rank: join the process group, train on this rank's device, leave."""
    import torch

    from .parallel.distributed import destroy_distributed, init_distributed
    from .training.loop import training_loop

    local_rank = rank if local_rank is None else local_rank
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    if dev.type == "cpu" and "OMP_NUM_THREADS" not in os.environ:
        # the host's cores shared by the ranks, not each rank's threads on all
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    world = init_distributed(backend, rank, world_size, init_method, dev)
    try:
        return training_loop(setup, device=dev, world=world)
    finally:
        destroy_distributed()


if __name__ == "__main__":
    main()
