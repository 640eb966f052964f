"""Metric registry and dispatcher (reference src/metrics/metric_main.py).
Counterpart of stylegan_v_tpu/metrics/metric_main.py, single process.

The registered metrics are the reference's (metric_main.py:96-152):
fid50k_full, kid50k_full, is50k, fvd2048_16f, fvd2048_128f,
fvd2048_128f_subsample8f, isv2048_ucf, and the legacy fid50k and kid50k.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..utils.misc import EasyDict
from . import frechet_inception_distance as fid_lib
from . import frechet_video_distance as fvd_lib
from . import inception_score as is_lib
from . import kernel_inception_distance as kid_lib
from .metric_utils import MetricOptions, check_single_process, metric_device

_metric_dict: Dict[str, Callable] = {}


def register_metric(fn: Callable) -> Callable:
    assert fn.__name__ not in _metric_dict
    _metric_dict[fn.__name__] = fn
    return fn


def is_valid_metric(metric: str) -> bool:
    return metric in _metric_dict


def list_valid_metrics() -> List[str]:
    return list(_metric_dict.keys())


def calc_metric(metric: str, num_runs: int = 1, **kwargs) -> EasyDict:
    """Run a metric, averaged over num_runs (reference metric_main.py:43-66),
    in this process on MetricOptions.device (cuda:0 when not given; no card
    raises). More than one replica or process raises NotImplementedError
    (ROADMAP P8)."""
    assert is_valid_metric(metric), f"unknown metric {metric}"
    opts = MetricOptions(**kwargs)
    check_single_process(opts)
    metric_device(opts)

    start = time.time()
    all_results: List[Dict[str, float]] = []
    for _ in range(num_runs):
        r = _metric_dict[metric](opts)
        all_results.append(r if isinstance(r, dict) else {metric: r})

    results = {}
    for key in all_results[0]:
        vals = [r[key] for r in all_results]
        results[key] = sum(vals) / len(vals)
        if num_runs > 1:
            results[key + "_std"] = float(np.std(vals))

    return EasyDict(
        results=EasyDict(results),
        metric=metric,
        total_time=time.time() - start,
        num_runs=num_runs,
    )


def report_metric(result_dict: Dict, run_dir: Optional[str] = None,
                  snapshot_pkl: Optional[str] = None,
                  snapshot_nimg: Optional[int] = None) -> None:
    """Append metric-<name>.jsonl (reference metric_main.py:81-91)."""
    metric = result_dict["metric"]
    rec = dict(result_dict)
    rec["snapshot"] = snapshot_pkl or (
        f"network-snapshot-{snapshot_nimg // 1000:06d}"
        if snapshot_nimg is not None else None)
    if snapshot_nimg is not None:
        rec["snapshot_nimg"] = int(snapshot_nimg)
    rec["timestamp"] = time.time()
    if run_dir is not None:
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, f"metric-{metric}.jsonl"), "at") as f:
            f.write(json.dumps(rec, default=float) + "\n")


# -------------------------------- registry ------------------------------------

@register_metric
def fid50k_full(opts):
    return {"fid50k_full": fid_lib.compute_fid(opts, max_real=None, num_gen=50000)}


@register_metric
def kid50k_full(opts):
    return {"kid50k_full": kid_lib.compute_kid(opts, max_real=1000000, num_gen=50000)}


@register_metric
def is50k(opts):
    mean, std = is_lib.compute_is(opts, num_gen=50000, num_splits=10)
    return {"is50k_mean": mean, "is50k_std": std}


@register_metric
def fvd2048_16f(opts):
    return {"fvd2048_16f": fvd_lib.compute_fvd(opts, max_real=2048, num_gen=2048,
                                               num_frames=16)}


@register_metric
def fvd2048_128f(opts):
    return {"fvd2048_128f": fvd_lib.compute_fvd(opts, max_real=2048, num_gen=2048,
                                                num_frames=128)}


@register_metric
def fvd2048_128f_subsample8f(opts):
    return {"fvd2048_128f_subsample8f": fvd_lib.compute_fvd(
        opts, max_real=2048, num_gen=2048, num_frames=16, subsample_factor=8)}


@register_metric
def isv2048_ucf(opts):
    mean, std = is_lib.compute_isv(opts, num_gen=2048, num_splits=10)
    return {"isv2048_ucf_mean": mean, "isv2048_ucf_std": std}


@register_metric
def fid50k(opts):
    return {"fid50k": fid_lib.compute_fid(opts, max_real=50000, num_gen=50000)}


@register_metric
def kid50k(opts):
    return {"kid50k": kid_lib.compute_kid(opts, max_real=50000, num_gen=50000)}
