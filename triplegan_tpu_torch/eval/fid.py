"""Fréchet Inception Distance between generated and real samples: the
port's own copy of ``triplegan_tpu/eval/fid.py``, with the same pluggable
feature space (an external extractor through ``eval/inception.py``'s
``load_scorer``, or the run's classifier's pooled features).

FID(a, b) = ||mu_a - mu_b||^2 + tr(C_a + C_b - 2 sqrtm(C_a C_b)).

The statistics are float64 numpy on the host: FID's trace arithmetic
cancels catastrophically in float32, and this runs once an eval. With
A = sqrtm(C_a) (a symmetric PSD eigendecomposition), tr(sqrtm(C_a C_b)) =
tr(sqrtm(A C_b A)), whose inner matrix is symmetric PSD: one more ``eigh``,
no scipy. Tiny negative eigenvalues of finite-sample noise are clipped.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

from triplegan_tpu_torch.eval.inception import host64


def activation_stats(features_fn: Callable, images, batch_size: int = 256
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Mean and covariance of ``features_fn`` over ``images``, driven in
    ``batch_size`` chunks (``preferred_batch`` of the extractor wins) and
    accumulated in float64."""
    batch_size = int(getattr(features_fn, "preferred_batch", None) or batch_size)
    chunks = [host64(features_fn(images[i : i + batch_size]))
              for i in range(0, images.shape[0], batch_size)]
    feats = np.concatenate(chunks, axis=0)
    if feats.ndim != 2:
        feats = feats.reshape(feats.shape[0], -1)
    mu = feats.mean(axis=0)
    cov = np.atleast_2d(np.cov(feats, rowvar=False))  # d = 1 is a scalar otherwise
    return mu, cov


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Symmetric-PSD square root by eigh, negative eigenvalue dust clipped."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1: np.ndarray, cov1: np.ndarray, mu2: np.ndarray, cov2: np.ndarray) -> float:
    """Fréchet distance between Gaussians N(mu1, cov1) and N(mu2, cov2)."""
    mu1 = np.asarray(mu1, np.float64)
    mu2 = np.asarray(mu2, np.float64)
    cov1 = np.atleast_2d(np.asarray(cov1, np.float64))
    cov2 = np.atleast_2d(np.asarray(cov2, np.float64))
    diff = mu1 - mu2
    a = _sqrtm_psd(cov1)
    inner = a @ cov2 @ a  # symmetric PSD, the nonzero spectrum of cov1 @ cov2
    vals = np.linalg.eigvalsh((inner + inner.T) / 2.0)
    tr_sqrt = float(np.sqrt(np.clip(vals, 0.0, None)).sum())
    fid = float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * tr_sqrt)
    return max(fid, 0.0)  # an exact zero lands at ≈ -1e-12


def fid_score(features_fn: Callable, images_a, images_b, batch_size: int = 256) -> float:
    """FID between two image sets under ``features_fn``: ``images_a`` the
    generated samples, ``images_b`` the real data, both in the input space
    the extractor expects (raw [-1, 1] for external scorers; the CLI
    whitens for the built-in classifier on zca configs)."""
    mu_a, cov_a = activation_stats(features_fn, images_a, batch_size)
    mu_b, cov_b = activation_stats(features_fn, images_b, batch_size)
    return frechet_distance(mu_a, cov_a, mu_b, cov_b)
