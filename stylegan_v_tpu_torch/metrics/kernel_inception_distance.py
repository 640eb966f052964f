"""KID: polynomial-kernel MMD over inception features (reference
src/metrics/kernel_inception_distance.py:18-44). Counterpart of
stylegan_v_tpu/metrics/kernel_inception_distance.py."""
from __future__ import annotations

import numpy as np

from . import metric_utils


def compute_kid(opts, max_real, num_gen, num_subsets: int = 100,
                max_subset_size: int = 1000,
                detector_name: str = "inception") -> float:
    detector_kwargs = dict(return_features=True)

    real = metric_utils.compute_feature_stats_for_dataset(
        opts=opts, detector_name=detector_name, detector_kwargs=detector_kwargs,
        capture_all=True, max_items=max_real, use_image_dataset=True).get_all()
    gen = metric_utils.compute_feature_stats_for_generator(
        opts=opts, detector_name=detector_name, detector_kwargs=detector_kwargs,
        capture_all=True, max_items=num_gen, num_video_frames=1).get_all()

    if opts.rank != 0:
        return float("nan")

    n = real.shape[1]
    m = min(min(real.shape[0], gen.shape[0]), max_subset_size)
    t = 0.0
    rng = np.random  # the reference draws the subsets from the global np.random too
    for _ in range(num_subsets):
        x = gen[rng.choice(gen.shape[0], m, replace=False)]
        y = real[rng.choice(real.shape[0], m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.diag(a).sum()) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m) * 1000.0
