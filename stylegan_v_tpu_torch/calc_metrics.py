"""Metric evaluation for a checkpoint (reference src/scripts/calc_metrics.py).

    python -m stylegan_v_tpu_torch.calc_metrics \\
        --network runs/exp/network-snapshot-000123.pt \\
        --metrics fvd2048_16f,fid50k_full --data /data/ffs_256.zip

The counterpart of scripts/calc_metrics.py over the port's metrics
(metrics/metric_main.py), with `--device` (default cuda; no card raises,
`--device cpu` runs on the CPU). The checkpoint is a port snapshot (.pt) or a
reference .pkl (generate.py:load_any_checkpoint); each metric appends one row
to metric-<name>.jsonl in --run-dir (default: the checkpoint's directory).
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict]:
    """The CLI; returns each metric's result."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--network", required=True, help="a snapshot (.pt) or a reference .pkl")
    ap.add_argument("--metrics", default="fvd2048_16f", help="comma-separated metric names")
    ap.add_argument("--data", required=True, help="dataset path (dir or zip)")
    ap.add_argument("--mirror", action="store_true")
    ap.add_argument("--detector-dir", default=None)
    ap.add_argument("--run-dir", default=None,
                    help="where to append metric jsonls (default: network dir)")
    ap.add_argument("--num-runs", type=int, default=1)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (the default), cuda:N or cpu")
    args = ap.parse_args(argv)

    from .generate import load_any_checkpoint
    from .metrics import metric_main
    from .training.loop import resolve_device

    device = resolve_device(args.device)
    G = load_any_checkpoint(args.network, device)
    run_dir = args.run_dir or os.path.dirname(os.path.abspath(args.network))
    dataset_kwargs = dict(path=args.data, sampling=G.cfg.sampling,
                          max_num_frames=G.cfg.sampling.max_num_frames,
                          xflip=args.mirror, resolution=G.cfg.img_resolution)

    results = {}
    for metric in args.metrics.split(","):
        metric = metric.strip()
        if not metric_main.is_valid_metric(metric):
            raise SystemExit(f"unknown metric {metric}; valid: "
                             f"{metric_main.list_valid_metrics()}")
        print(f"Computing {metric}...")
        result = metric_main.calc_metric(
            metric=metric, num_runs=args.num_runs, G=G, dataset_kwargs=dataset_kwargs,
            detector_dir=args.detector_dir, device=device, verbose=args.verbose)
        metric_main.report_metric(result, run_dir=run_dir,
                                  snapshot_pkl=os.path.basename(args.network))
        print(f"  {metric}: {dict(result['results'])}  ({result['total_time']:.1f}s)")
        results[metric] = result
    return results


if __name__ == "__main__":
    main()
