"""Inception Score (reference src/metrics/inception_score.py:18-45) and the
Video Inception Score over C3D-UCF101 (reference
src/metrics/video_inception_score.py:14-52). Counterpart of
stylegan_v_tpu/metrics/inception_score.py."""
from __future__ import annotations

import numpy as np

from . import metric_utils


def compute_is(opts, num_gen, num_splits: int = 10,
               detector_name: str = "inception"):
    detector_kwargs = dict(no_output_bias=True)

    if opts.generator_as_dataset:
        gen_probs = metric_utils.compute_feature_stats_for_dataset(
            opts=metric_utils.rewrite_opts_for_gen_dataset(opts),
            detector_name=detector_name, detector_kwargs=detector_kwargs,
            capture_all=True, max_items=num_gen, use_image_dataset=True).get_all()
    else:
        gen_probs = metric_utils.compute_feature_stats_for_generator(
            opts=opts, detector_name=detector_name,
            detector_kwargs=detector_kwargs, capture_all=True,
            max_items=num_gen, num_video_frames=1).get_all()

    if opts.rank != 0:
        return float("nan"), float("nan")

    scores = []
    for i in range(num_splits):
        part = gen_probs[i * num_gen // num_splits:(i + 1) * num_gen // num_splits]
        kl = part * (np.log(part) - np.log(np.mean(part, axis=0, keepdims=True)))
        kl = np.mean(np.sum(kl, axis=1))
        scores.append(np.exp(kl))
    return float(np.mean(scores)), float(np.std(scores))


def compute_isv(opts, num_gen, num_splits: int = 10, num_video_frames: int = 16,
                detector_name: str = "c3d_ucf101"):
    """Video Inception Score over C3D-UCF101 probabilities."""
    detector_kwargs = dict()
    gen_probs = metric_utils.compute_feature_stats_for_generator(
        opts=opts, detector_name=detector_name, detector_kwargs=detector_kwargs,
        capture_all=True, max_items=num_gen, temporal_detector=True,
        num_video_frames=num_video_frames,
        batch_size=num_video_frames * 4).get_all()

    if opts.rank != 0:
        return float("nan"), float("nan")

    rng = np.random.RandomState(42)   # seeded splits (reference :46)
    perm = rng.permutation(len(gen_probs))
    gen_probs = gen_probs[perm]
    scores = []
    for i in range(num_splits):
        part = gen_probs[i * num_gen // num_splits:(i + 1) * num_gen // num_splits]
        kl = part * (np.log(part + 1e-12)
                     - np.log(np.mean(part, axis=0, keepdims=True) + 1e-12))
        kl = np.mean(np.sum(kl, axis=1))
        scores.append(np.exp(kl))
    return float(np.mean(scores)), float(np.std(scores))
