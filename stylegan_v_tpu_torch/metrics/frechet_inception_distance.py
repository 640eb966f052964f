"""FID (reference src/metrics/frechet_inception_distance.py; math matches
Heusel et al. TTUR). Counterpart of
stylegan_v_tpu/metrics/frechet_inception_distance.py; `frechet_distance` is a
copy."""
from __future__ import annotations

import numpy as np

from . import metric_utils

NUM_FRAMES_IN_BATCH = {128: 32, 256: 32, 512: 8, 1024: 2}


def frechet_distance(mu_real, sigma_real, mu_gen, sigma_gen,
                     method: str = "eigh") -> float:
    """d^2 = |mu_g - mu_r|^2 + tr(Sig_g + Sig_r - 2 sqrtm(Sig_g Sig_r)).

    method='sqrtm' is the reference formulation
    (frechet_inception_distance.py:28: scipy.linalg.sqrtm of the product).
    method='eigh' (default) computes the SAME quantity through the
    symmetric form tr sqrtm(Sig_g Sig_r) = sum_i sqrt(lambda_i(S Sig_g S))
    with S = sqrtm(Sig_r) from an eigendecomposition (exact for PSD Sig_r):
    two LAPACK *syevd calls with deterministic O(n^3) cost, where scipy's
    Schur-based sqrtm takes minutes on the singular covariances that every
    num_items < num_features run produces.

    Non-finite moments (e.g. a detector overflow) return +inf instead of
    feeding NaN to LAPACK — a poisoned metric must rank WORST, not hang."""
    if not (np.isfinite(mu_real).all() and np.isfinite(mu_gen).all()
            and np.isfinite(sigma_real).all() and np.isfinite(sigma_gen).all()):
        return float("inf")
    m = np.square(mu_gen - mu_real).sum()
    if method == "sqrtm":
        import scipy.linalg
        s, _ = scipy.linalg.sqrtm(np.dot(sigma_gen, sigma_real), disp=False)
        tr_s = np.real(np.trace(s))
    else:
        # S = Sig_r^(1/2) via eigh (clip tiny negative eigenvalues of the
        # nominally-PSD covariance); then eigh of the PSD S Sig_g S
        d, u = np.linalg.eigh(sigma_real)
        sq = u * np.sqrt(np.clip(d, 0.0, None))[None, :]    # U diag(sqrt d)
        inner = sq.T @ sigma_gen @ sq                        # = S Sig_g S (sym)
        lam = np.linalg.eigvalsh((inner + inner.T) * 0.5)
        tr_s = float(np.sqrt(np.clip(lam, 0.0, None)).sum())
    return float(np.real(m + np.trace(sigma_gen + sigma_real) - 2.0 * tr_s))


def compute_fid(opts, max_real, num_gen, detector_name: str = "inception") -> float:
    detector_kwargs = dict(return_features=True)
    resolution = opts.dataset_kwargs.get("resolution") or 256
    batch_size = NUM_FRAMES_IN_BATCH.get(resolution, 32)

    mu_real, sigma_real = metric_utils.compute_feature_stats_for_dataset(
        opts=opts, detector_name=detector_name, detector_kwargs=detector_kwargs,
        capture_mean_cov=True, max_items=max_real,
        use_image_dataset=True).get_mean_cov()

    if opts.generator_as_dataset:
        stats = metric_utils.compute_feature_stats_for_dataset(
            opts=metric_utils.rewrite_opts_for_gen_dataset(opts),
            detector_name=detector_name, detector_kwargs=detector_kwargs,
            capture_mean_cov=True, max_items=num_gen, use_image_dataset=True)
    else:
        stats = metric_utils.compute_feature_stats_for_generator(
            opts=opts, detector_name=detector_name, detector_kwargs=detector_kwargs,
            batch_size=batch_size, num_video_frames=1,
            capture_mean_cov=True, max_items=num_gen)
    mu_gen, sigma_gen = stats.get_mean_cov()

    if opts.rank != 0:
        return float("nan")
    return frechet_distance(mu_real, sigma_real, mu_gen, sigma_gen)
