"""Re-score a demo run's snapshots under a given random-I3D seed.

    python -m stylegan_v_tpu_torch.fvd_demo_backfill --outdir runs/fvd_demo_torch \\
        --data data/moving64.zip --detector-seed 18 \\
        --out-jsonl runs/fvd_demo_torch/metric-fvd2048_16f.seed18.jsonl --force

The counterpart of scripts/fvd_demo_backfill.py (companion to
train_fvd_demo.py), with its flags plus `--device` (default cuda; `--device
cpu` runs on the CPU). For each network-snapshot-<kimg>.pt in --outdir that
has no row in the jsonl (every one with --force, which appends), it loads
the snapshot's G_ema, registers the demo's random I3D under
--detector-seed and appends one fvd2048_16f row, keyed by the snapshot's
name as the training loop writes it (network-snapshot-000016), which is
what scripts/fvd_seed_agreement.py joins the series on.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    """The CLI; returns the rows it appended."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--outdir", default="runs/fvd_demo")
    ap.add_argument("--data", default="data/moving64.zip")
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--dataset-frames", type=int, default=32)
    ap.add_argument("--fvd-items", type=int, default=256)
    ap.add_argument("--detector-seed", type=int, default=17)
    ap.add_argument("--out-jsonl", default=None,
                    help="metric jsonl to read and append (default: the run's "
                         "metric-fvd2048_16f.jsonl); give each detector seed its own file")
    ap.add_argument("--force", action="store_true",
                    help="re-score snapshots even if already recorded")
    ap.add_argument("--device", default="cuda", help="cuda (the default), cuda:N or cpu")
    args = ap.parse_args(argv)

    from .generate import load_any_checkpoint
    from .io.checkpoint import SNAPSHOT_RE
    from .metrics import metric_main
    from .models.config import SamplingConfig
    from .train_fvd_demo import FVD_FRAMES, METRIC, register_random_i3d
    from .training.loop import resolve_device

    device = resolve_device(args.device)
    register_random_i3d(args.detector_seed, FVD_FRAMES, args.res, resize224=False,
                        device=device)
    jsonl = (args.out_jsonl if args.out_jsonl is not None
             else os.path.join(args.outdir, f"metric-{METRIC}.jsonl"))
    have = set()
    if os.path.exists(jsonl) and not args.force:
        with open(jsonl) as f:
            have = {json.loads(line).get("snapshot") for line in f}

    sampling = SamplingConfig(num_frames_per_video=3, max_num_frames=args.dataset_frames)
    snaps = sorted((int(m.group(1)), n) for n in os.listdir(args.outdir)
                   if (m := SNAPSHOT_RE.match(n)))
    rows = []
    for kimg, fname in snaps:
        name = os.path.splitext(fname)[0]
        if name in have:
            print(f"{name}: already recorded, skip", flush=True)
            continue
        G = load_any_checkpoint(os.path.join(args.outdir, fname), device)
        r = metric_main.calc_metric(
            metric=METRIC, G=G, device=device,
            dataset_kwargs=dict(path=args.data, sampling=sampling,
                                max_num_frames=args.dataset_frames),
            max_real_override=args.fvd_items, num_gen_override=args.fvd_items)
        rec = dict(r, snapshot=name, snapshot_nimg=kimg * 1000,
                   detector_seed=args.detector_seed, timestamp=time.time())
        with open(jsonl, "at") as f:
            f.write(json.dumps(rec, default=float) + "\n")
        rows.append(rec)
        print(f"{name}: {dict(r['results'])} (seed {args.detector_seed})", flush=True)
    return rows


if __name__ == "__main__":
    main()
