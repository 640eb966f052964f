"""Experiment launcher of the port (reference src/infra/launch.py).

    python -m stylegan_v_tpu_torch.launch dataset=ffs dataset.path=/data/ffs.zip \\
        exp_suffix=run1 [--print-only] [--jobs 3] [--device cuda]

The counterpart of scripts/launch.py (the JAX package's). It composes
configs/ with the overrides, then makes a project release dir: a code
snapshot (`code/`: stylegan_v_tpu_torch/ and configs/, sources only), the
frozen experiment_config.yaml and training_cmd.sh. Then it runs a job
sequence, or prints it with --print-only: job 1 is

    cd <run_dir>/code && python -m stylegan_v_tpu_torch.train \\
        --cfg-path <run_dir>/experiment_config.yaml --device <device>

and jobs 2..N append `training.resume=latest`, the reference's SLURM
`--dependency=afterany` chain for preemptible capacity (reference
launch.py:72-104): each job resumes from the snapshot the one before it left.
Jobs run the snapshot's code from its directory, so the frozen config holds
its paths (the run dir, the dataset, a resume file) made absolute against the
directory launch ran in. A dirty git checkout is refused unless
--allow-dirty: the release dir must be reproducible. `--device` defaults to
cuda; without a card that raises, and `--device cpu` runs the jobs on the CPU.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from typing import List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# config keys that hold a path (a resume value may also be "latest")
PATH_KEYS = ("project_release_dir", "dataset.path", "training.data", "training.outdir",
             "training.resume")


def git_is_clean() -> bool:
    try:
        out = subprocess.run(["git", "status", "--porcelain"], cwd=REPO,
                             capture_output=True, text=True, timeout=30)
        return out.returncode == 0 and not out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return True   # no git to ask: skip the check


def absolute_paths(cfg) -> None:
    """Make the relative paths of PATH_KEYS in cfg absolute against the cwd."""
    from .utils import config as cfglib
    for key in PATH_KEYS:
        node = cfg
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.get(p) or {}
        value = node.get(leaf)
        if isinstance(value, str) and value != "latest" and not os.path.isabs(value):
            cfglib.set_by_path(cfg, key, os.path.abspath(value))


def snapshot_code(code_dir: str) -> None:
    """The port and configs/ copied into code_dir, sources only (no _build)."""
    os.makedirs(code_dir)
    for item in ("stylegan_v_tpu_torch", "configs"):
        shutil.copytree(os.path.join(REPO, item), os.path.join(code_dir, item),
                        ignore=shutil.ignore_patterns("__pycache__", "_build"))


def create_project_dir(cfg, run_dir: str) -> None:
    """Code snapshot + frozen config (reference infra/utils.py:56-82); a code
    snapshot already in the run dir is kept."""
    from .utils import config as cfglib
    os.makedirs(run_dir, exist_ok=True)
    code_dir = os.path.join(run_dir, "code")
    if not os.path.exists(code_dir):
        snapshot_code(code_dir)
    cfglib.save(cfg, os.path.join(run_dir, "experiment_config.yaml"))


def job_commands(run_dir: str, n_jobs: int, device: str) -> List[List[str]]:
    """The job sequence: `python -m stylegan_v_tpu_torch.train` on the frozen
    config, jobs 2..n resuming from the latest snapshot."""
    base = [sys.executable, "-m", "stylegan_v_tpu_torch.train", "--cfg-path",
            os.path.join(run_dir, "experiment_config.yaml"), "--device", device]
    return [base] + [base + ["training.resume=latest"] for _ in range(1, n_jobs)]


def main(argv: Optional[List[str]] = None) -> List[int]:
    """The CLI; returns the jobs' exit codes (none with --print-only)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("overrides", nargs="*")
    ap.add_argument("--config-dir", default=os.path.join(REPO, "configs"))
    ap.add_argument("--jobs", type=int, default=None,
                    help="job sequence length (default: infra.job_sequence_length)")
    ap.add_argument("--print-only", action="store_true",
                    help="print commands without executing (reference print_only)")
    ap.add_argument("--allow-dirty", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (the default), cuda:N or cpu")
    args = ap.parse_intermixed_args(argv)

    from .training.loop import resolve_device
    from .utils import config as cfglib

    resolve_device(args.device)
    cfg = cfglib.load_config(args.config_dir, args.overrides)
    cfg.setdefault("project_release_dir", "runs/exp")
    absolute_paths(cfg)
    run_dir = cfg.project_release_dir

    if not args.allow_dirty and not git_is_clean():
        raise SystemExit(
            "Refusing to launch from a dirty git checkout (the release dir "
            "must be reproducible; reference infra/utils.py:64-68). "
            "Commit your changes or pass --allow-dirty.")

    create_project_dir(cfg, run_dir)
    n_jobs = args.jobs or int(cfg.get("infra", {}).get("job_sequence_length", 1))
    code_dir = os.path.join(run_dir, "code")
    cmds = job_commands(run_dir, n_jobs, args.device)
    with open(os.path.join(run_dir, "training_cmd.sh"), "w") as f:
        f.write(f"#!/bin/sh\ncd {code_dir} || exit 1\n"
                + "\n".join(" ".join(c) for c in cmds) + "\n")

    if args.print_only or cfg.get("infra", {}).get("print_only"):
        for c in cmds:
            print(f"cd {code_dir} && {' '.join(c)}")
        return []

    rets = []
    for i, c in enumerate(cmds):
        print(f"[launch] job {i + 1}/{len(cmds)}: {' '.join(c)}", flush=True)
        rets.append(subprocess.run(c, cwd=code_dir).returncode)
        print(f"[launch] job {i + 1} exited with {rets[-1]}", flush=True)
    return rets


if __name__ == "__main__":
    main()
