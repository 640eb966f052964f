"""FVD/FID between two frame datasets, real against generated dirs or zips
(reference src/scripts/calc_metrics_for_dataset.py).

    python -m stylegan_v_tpu_torch.calc_metrics_for_dataset \\
        --real-data /data/real_frames --fake-data /data/fake_frames \\
        --metrics fvd2048_16f,fid50k_full

The counterpart of scripts/calc_metrics_for_dataset.py over the port's
metrics: the second dataset stands in for the generator
(`generator_as_dataset`), on `--device` (default cuda; no card raises,
`--device cpu` runs on the CPU). Each metric appends one row to
metric-<name>.jsonl in --run-dir.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict]:
    """The CLI; returns each metric's result."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--real-data", required=True)
    ap.add_argument("--fake-data", required=True)
    ap.add_argument("--metrics", default="fvd2048_16f")
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--max-num-frames", type=int, default=1024)
    ap.add_argument("--mirror", action="store_true")
    ap.add_argument("--detector-dir", default=None)
    ap.add_argument("--run-dir", default=".")
    ap.add_argument("--device", default="cuda", help="cuda (the default), cuda:N or cpu")
    args = ap.parse_args(argv)

    from .metrics import metric_main
    from .models.config import SamplingConfig
    from .training.loop import resolve_device

    device = resolve_device(args.device)
    sampling = SamplingConfig(max_num_frames=args.max_num_frames)
    common = dict(sampling=sampling, max_num_frames=args.max_num_frames,
                  xflip=args.mirror, resolution=args.resolution)

    results = {}
    for metric in args.metrics.split(","):
        metric = metric.strip()
        if not metric_main.is_valid_metric(metric):
            raise SystemExit(f"unknown metric {metric}")
        print(f"Computing {metric} (dataset vs dataset)...")
        result = metric_main.calc_metric(
            metric=metric, dataset_kwargs=dict(path=args.real_data, **common),
            gen_dataset_kwargs=dict(path=args.fake_data, **common),
            generator_as_dataset=True, detector_dir=args.detector_dir, device=device)
        metric_main.report_metric(result, run_dir=args.run_dir)
        print(f"  {metric}: {dict(result['results'])}")
        results[metric] = result
    return results


if __name__ == "__main__":
    main()
