"""ZCA whitening: fit once on the host in float64 numpy, apply on the device
as one matmul. Mirrors ``triplegan_tpu/data/zca.py``."""

from __future__ import annotations

import dataclasses
import os
import warnings

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ZCAStats:
    """mean: (D,) and whitening matrix W: (D, D), D = H*W*C."""

    mean: np.ndarray
    whiten: np.ndarray

    def save(self, path: str) -> None:
        """Publish atomically: write ``<path>.<pid>.tmp.npz`` and rename it
        to ``path``, so a reader never sees a torn file."""
        tmp = f"{path}.{os.getpid()}.tmp.npz"  # the .npz suffix, or np.savez appends one
        np.savez(tmp, mean=self.mean, whiten=self.whiten)
        os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> "ZCAStats":
        with np.load(path, allow_pickle=False) as z:
            return ZCAStats(mean=z["mean"], whiten=z["whiten"])


def fit_zca(images: np.ndarray, eps: float = 1e-5) -> ZCAStats:
    """Fit ZCA on uint8/float images (N, H, W, C) rescaled to [-1, 1]:
    float64 covariance and symmetric eigendecomposition, float32 result.
    N should exceed D = H·W·C, or the whitening amplifies the covariance's
    null directions by 1/sqrt(eps) (a warning says so)."""
    n = images.shape[0]
    dims = int(np.prod(images.shape[1:]))
    if n < dims:
        warnings.warn(
            f"fit_zca: {n} samples < {dims} dims — covariance is rank-"
            "deficient; whitening will amplify null directions on unseen "
            "data. Fit on more samples or disable ZCA.",
            stacklevel=2,
        )
    flat = images.reshape(n, -1).astype(np.float64)
    flat = flat / 127.5 - 1.0
    mean = flat.mean(axis=0)
    centered = flat - mean
    cov = centered.T @ centered / n
    eigval, eigvec = np.linalg.eigh(cov)
    eigval = np.maximum(eigval, 0.0)
    whiten = (eigvec * (1.0 / np.sqrt(eigval + eps))) @ eigvec.T
    return ZCAStats(mean=mean.astype(np.float32), whiten=whiten.astype(np.float32))


def apply_zca(x: torch.Tensor, mean: torch.Tensor, whiten: torch.Tensor) -> torch.Tensor:
    """(N,H,W,C) in [-1,1] → whitened (N,H,W,C): ``(flat − mean) @ whiten.T``
    in x's dtype."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    white = (flat - mean.to(flat.dtype)) @ whiten.to(flat.dtype).T
    return white.reshape(x.shape)
